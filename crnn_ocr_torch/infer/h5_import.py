"""Keras ``.h5`` weights in and out, at the JAX package's path
(``crnn_ocr_tpu/infer/h5_import.py``).

``import_keras_h5(path, cfg, name_map=None)`` returns the JAX package's
``(params, batch_stats)`` numpy trees (``infer.weights.params_from_jax``
maps them onto ``CRNN``); ``export_keras_h5(state_dict, cfg, path)`` takes
a ``CRNN`` state_dict where JAX takes ``params, batch_stats``. Both live in
``infer/weights.py``, which reads and writes through the port's own HDF5
code (``infer/hdf5.py``), not ``h5py``.
"""

from crnn_ocr_torch.infer.weights import export_keras_h5, import_keras_h5

__all__ = ["export_keras_h5", "import_keras_h5"]
