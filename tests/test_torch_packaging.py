"""``pyproject.toml`` ships the port: its packages, the CUDA and C++
sources it builds at first use, and its four console scripts, beside the
JAX package's unchanged ones. Parses and imports; builds nothing."""

import fnmatch
import pathlib
import subprocess
import sys
import tomllib

import setuptools

from crnn_ocr_torch.kernels import _build

REPO = pathlib.Path(__file__).resolve().parent.parent
PYPROJECT = tomllib.loads((REPO / "pyproject.toml").read_text())
TOOL = PYPROJECT["tool"]["setuptools"]
SCRIPTS = PYPROJECT["project"]["scripts"]


def _found():
    """The packages setuptools finds with the project's patterns
    (``packages.find``: namespace packages on, as pyproject's default)."""
    find = TOOL["packages"]["find"]
    return set(setuptools.find_namespace_packages(
        where=str(REPO), include=find["include"],
        exclude=find.get("exclude", ())))


def test_every_port_package_is_found_and_no_data_directory():
    found = _found()
    want = {p.parent.relative_to(REPO).as_posix().replace("/", ".")
            for p in (REPO / "crnn_ocr_torch").rglob("__init__.py")
            if "_build" not in p.parts}
    assert want and want <= found, want - found
    assert "crnn_ocr_tpu" in found and "crnn_ocr_tpu.models" in found
    shipped = [p for p in found if p.startswith("crnn_ocr_torch.")
               and p.split(".")[1] in ("testdata", "_build")]
    assert not shipped, shipped


def _globbed(pkg: str):
    root = REPO / pkg.replace(".", "/")
    files = {p.relative_to(root).as_posix() for p in root.rglob("*")
             if p.is_file()}
    return {f for f in files
            if any(fnmatch.fnmatch(f, g) for g in TOOL["package-data"][pkg])}


def test_package_data_holds_the_kernel_and_native_sources():
    cu = _globbed("crnn_ocr_torch.kernels")
    assert {f"csrc/{name}.cu" for name in _build.SOURCES} <= cu
    cc = {p.name for p in (REPO / "crnn_ocr_torch" / "native").glob("*.cc")}
    assert cc and cc == _globbed("crnn_ocr_torch.native")
    # the JAX package's own data, as it was
    assert TOOL["package-data"]["crnn_ocr_tpu.native"] == ["Makefile",
                                                           "src/*.cc"]


def test_console_scripts_import_without_jax():
    port = {k: v for k, v in SCRIPTS.items() if k.startswith("crnn-ocr-torch-")}
    assert sorted(port) == [f"crnn-ocr-torch-{n}" for n in
                            ("migrate", "predict", "serve", "train")]
    for name, target in port.items():
        assert target == f"crnn_ocr_torch.cli.{name.rsplit('-', 1)[1]}:main"
    # the JAX package's scripts stay as they were
    for n in ("train", "predict", "migrate", "serve"):
        assert SCRIPTS[f"crnn-ocr-{n}"] == f"crnn_ocr_tpu.cli.{n}:main"
    # a fresh interpreter in which JAX and the JAX package cannot import
    code = "\n".join([
        "import importlib, sys",
        "sys.modules.update(dict.fromkeys(('jax', 'crnn_ocr_tpu'), None))",
        f"for t in {sorted(port.values())!r}:",
        "    mod, fn = t.split(':')",
        "    assert callable(getattr(importlib.import_module(mod), fn)), t",
    ])
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    extra = PYPROJECT["project"]["optional-dependencies"]["torch"]
    assert extra == ["torch", "numpy", "opencv-python"]
