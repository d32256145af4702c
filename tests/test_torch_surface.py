"""The port's public surface against the JAX package's, name by name.

For every module of ``crnn_ocr_tpu`` (the prebuilt ``libcrnnocr`` aside),
every public name (each ``__all__`` entry, each top-level function and
class defined there, each top-level constant) must be found in the
``crnn_ocr_torch`` module at the same path, or be listed in
``crnn_ocr_torch/counterparts.py::JAX_COUNTERPARTS`` with its counterpart
or the reason there is none. Every JAX parameter of a callable that both
packages define must be in the port's signature, or listed in
``PARAMETER_EXEMPTIONS`` with its reason. Both maps are held exact: an
entry for a name the port now has, or for a parameter it now takes, fails.
These tests import and parse; they compile nothing.
"""

import ast
import importlib
import inspect
import pathlib
import subprocess
import sys

import pytest

from crnn_ocr_torch import counterparts
from crnn_ocr_torch.counterparts import JAX_COUNTERPARTS, PARAMETER_EXEMPTIONS

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX, PORT = "crnn_ocr_tpu", "crnn_ocr_torch"


def _relative_modules():
    """The JAX package's modules, relative to it ("" is the package)."""
    out = []
    for p in sorted((REPO / JAX).rglob("*.py")):
        parts = p.relative_to(REPO / JAX).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if "libcrnnocr" in parts:
            continue
        out.append(".".join(parts))
    return out


MODULES = _relative_modules()


def _module(pkg: str, rel: str):
    return importlib.import_module(f"{pkg}.{rel}" if rel else pkg)


def _defined_constants(rel: str):
    """Public names a JAX module assigns at its top level."""
    path = REPO / JAX / (rel.replace(".", "/") or ".")
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_") and n != "__all__"]


def _public(rel: str):
    """{name: key} of a JAX module's public names; the key is
    ``"<defining module>:<name>"``, relative to the package."""
    mod = _module(JAX, rel)
    names = set(getattr(mod, "__all__", ())) | set(_defined_constants(rel))
    for k, v in vars(mod).items():
        if (not k.startswith("_")
                and (inspect.isfunction(v) or inspect.isclass(v))
                and v.__module__ == mod.__name__):
            names.add(k)
    out = {}
    for k in sorted(names):
        v = getattr(mod, k)
        home = getattr(v, "__module__", None) if (
            inspect.isfunction(v) or inspect.isclass(v)) else None
        home = home if home and home.startswith(JAX) else mod.__name__
        out[k] = f"{home[len(JAX) + 1:]}:{k}"
    return out


def _resolve(ref: str):
    rel, name = ref.split(":")
    return getattr(_module(PORT, rel), name)


def _params(fn):
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return []


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_is_ported_or_mapped(rel):
    port = _module(PORT, rel)
    missing = [key for name, key in _public(rel).items()
               if not hasattr(port, name) and key not in JAX_COUNTERPARTS]
    assert not missing, (f"{PORT}.{rel} lacks these JAX names and "
                         f"counterparts.py does not map them: {missing}")


def test_mapping_is_exact_and_its_counterparts_import():
    for key, (target, why) in JAX_COUNTERPARTS.items():
        rel, name = key.split(":")
        assert hasattr(_module(JAX, rel), name), f"{key}: JAX has no such name"
        assert not hasattr(_module(PORT, rel), name), (
            f"{key}: the port now defines it; the entry is stale")
        assert why.strip(), f"{key}: an entry needs its reason"
        if target is not None:
            assert _resolve(target) is not None, target


def _pairs():
    """(key, JAX callable, port callable) of every public callable both
    packages define under one name, once per defining module."""
    seen = {}
    for rel in MODULES:
        port = _module(PORT, rel)
        jmod = _module(JAX, rel)
        for name, key in _public(rel).items():
            a, b = getattr(jmod, name), getattr(port, name, None)
            if (key not in seen and b is not None
                    and (inspect.isfunction(a) or inspect.isclass(a))
                    and callable(b)):
                seen[key] = (a, b)
    return seen


def test_every_jax_parameter_is_taken_or_exempt():
    missing = {}
    for key, (a, b) in _pairs().items():
        lacks = [p for p in _params(a) if p not in _params(b)
                 and p not in PARAMETER_EXEMPTIONS.get(key, {})]
        if lacks:
            missing[key] = lacks
    assert not missing, f"parameters the port lacks, unlisted: {missing}"


def test_parameter_exemptions_are_exact():
    pairs = _pairs()
    for key, params in PARAMETER_EXEMPTIONS.items():
        assert key in pairs, f"{key}: not a callable both packages define"
        a, b = pairs[key]
        for p, why in params.items():
            assert p in _params(a), f"{key}: JAX takes no {p!r}"
            assert p not in _params(b), (
                f"{key}: the port now takes {p!r}; the exemption is stale")
            assert why.strip(), f"{key}.{p}: an exemption needs its reason"


@pytest.mark.parametrize("pkg", [
    "ops", "utils", "models", "infer", "train", "data", "parallel", "serve"])
def test_package_exports_match_jax(pkg):
    """Each port package exports every name of JAX's ``__all__`` that is
    not mapped, and each of its own ``__all__`` resolves."""
    jmod, port = _module(JAX, pkg), _module(PORT, pkg)
    want = set(getattr(jmod, "__all__", ()))
    unmapped = {n for n, key in _public(pkg).items()
                if n in want and key not in JAX_COUNTERPARTS}
    assert unmapped <= set(getattr(port, "__all__", ())), (
        unmapped - set(getattr(port, "__all__", ())))
    for name in getattr(port, "__all__", ()):
        assert getattr(port, name) is not None, name


def test_jax_import_paths_work_on_the_port():
    from crnn_ocr_torch.infer.h5_import import export_keras_h5, import_keras_h5
    from crnn_ocr_torch.models import STN, ModelConfig, build_model
    from crnn_ocr_torch.ops import (
        bilinear_sample,
        ctc_decode,
        ctc_loss_from_log_probs,
        grid_sample_affine,
    )
    from crnn_ocr_torch.ops.ctc import ctc_forward_log_loss
    from crnn_ocr_torch.ops.ctc_beam_device import (
        DISPATCH_BLOCK,
        KERAS_EPSILON,
        NEG,
    )
    from crnn_ocr_torch.utils import cer, levenshtein

    assert (DISPATCH_BLOCK, KERAS_EPSILON, NEG) == (0, 1e-7, -1e30)
    assert all(callable(f) for f in (
        export_keras_h5, import_keras_h5, STN, ModelConfig, build_model,
        bilinear_sample, ctc_decode, ctc_loss_from_log_probs,
        grid_sample_affine, ctc_forward_log_loss, cer, levenshtein))


@pytest.mark.parametrize("entry", ["ctc_beam_search_decode_tf",
                                   "ctc_beam_tier_stats"])
def test_beam_refuses_a_dispatch_block(monkeypatch, entry):
    """The port has only the batch-global tier ladder: a non-zero
    ``DISPATCH_BLOCK`` (JAX's per-sub-block ladders) raises, not ignored."""
    import torch

    from crnn_ocr_torch.ops import ctc_beam_device as beam

    monkeypatch.setattr(beam, "DISPATCH_BLOCK", 4)
    probs = torch.full((2, 3, 4), 0.25)
    with pytest.raises(NotImplementedError, match="DISPATCH_BLOCK = 4"):
        getattr(beam, entry)(probs, torch.tensor([3, 2]))


def test_readme_prints_the_mapping():
    readme = "\n".join(line.strip() for line in
                       (REPO / "README.md").read_text().splitlines())
    assert counterparts.markdown() in readme, (
        "README.md's port section must hold `python -m "
        "crnn_ocr_torch.counterparts`'s tables as printed")


@pytest.mark.parametrize("first", ["ops", "models", "utils", "infer"])
def test_package_imports_are_acyclic_and_build_nothing(first):
    """Each port package imports first in a fresh interpreter (no cycle
    through ``ops``), without JAX, building or loading no kernel or host
    library: those build at their first use."""
    code = "\n".join([
        "import importlib, sys",
        "sys.modules.update(dict.fromkeys(('jax', 'crnn_ocr_tpu'), None))",
        "for pkg in sys.argv[1:]:",
        "    importlib.import_module(pkg)",
        "from crnn_ocr_torch import native",
        "from crnn_ocr_torch.kernels import _build",
        "assert not _build._libs and not native._libs",
    ])
    rest = [p for p in ("ops", "models", "utils", "infer", "train", "data",
                        "parallel", "serve", "infer.h5_import") if p != first]
    done = subprocess.run(
        [sys.executable, "-c", code,
         *(f"{PORT}.{p}" for p in [first] + rest)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
