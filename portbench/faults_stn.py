"""A fault of the STN cell (``drivers/train_stn.py``), planted under the
timed path as ``faults.py`` plants its own:

* ``k12_doubled``: K12's coordinate gradients doubled, so the gradient at
  theta that K12 carries to the localization net is twice what it is
  (swapped in for each train step, restored after it).
"""

from __future__ import annotations


def k12_doubled() -> dict:
    from crnn_ocr_torch.kernels import grid_sample

    bwd = grid_sample.sample_pix_bwd

    def doubled(img, x, y, g, *args, **kwargs):
        dimg, dx, dy = bwd(img, x, y, g, *args, **kwargs)
        return dimg, 2 * dx, 2 * dy

    def wrap(step):
        def swapped(state, batch, generator=None):
            grid_sample.sample_pix_bwd = doubled
            try:
                return step(state, batch, generator)
            finally:
                grid_sample.sample_pix_bwd = bwd
        return swapped

    return {"train_step": wrap}


FAULTS = {"k12_doubled": k12_doubled}
