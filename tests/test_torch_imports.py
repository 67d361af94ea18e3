"""The port stands alone: it imports neither jax nor the JAX package."""

import pathlib
import subprocess
import sys

from torch_pin import one_intra_op_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = "nes_img_captioning_tpu_torch"


def _modules():
    root = REPO / PKG
    return sorted(
        ".".join((PKG,) + p.relative_to(root).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in root.rglob("*.py"))


def test_port_imports_without_jax():
    """Every module of the port, ``parallel/`` included, imports with
    ``jax`` blocked, and no module of nes_img_captioning_tpu gets loaded."""
    mods = _modules()
    assert len(mods) > 20
    assert {f"{PKG}.parallel", f"{PKG}.parallel.mesh",
            f"{PKG}.parallel.multihost"} <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m] is not"
        " None or m.startswith(('jax.', 'nes_img_captioning_tpu.'))"
        " or m == 'nes_img_captioning_tpu']\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_imports_without_h5py():
    """Every module of the port imports with ``h5py`` blocked: the label
    file is read by the port's own HDF5 subset (data/hdf5.py), on the CPU
    and on the card alike."""
    mods = _modules()
    assert f"{PKG}.data.hdf5" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['h5py'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    for path in [*(REPO / PKG).rglob("*.py"), REPO / "chip_smoke.py",
                 REPO / "scripts" / "torch_parity_run.py"]:
        text = path.read_text()
        assert "import h5py" not in text, path


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py drives only the port."""
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "nes_img_captioning_tpu." not in src


def test_no_source_names_jax():
    for path in (REPO / PKG).rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text, path
        assert "from jax" not in text, path
        assert "from nes_img_captioning_tpu." not in text, path
        assert "import nes_img_captioning_tpu." not in text, path
