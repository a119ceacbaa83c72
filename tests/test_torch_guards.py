"""Guards on the port's boundaries: it imports without JAX (and without
h5py, orbax or optax, which the card's machine lacks), it names nothing of
the JAX package, and its kernel wrappers, the autograd Function over them
and the training entry point raise instead of falling back when CUDA is
missing."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dycon_paper_replication_tpu_torch import config
from dycon_paper_replication_tpu_torch.ops import folded_conv_cuda
from dycon_paper_replication_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dycon_paper_replication_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_h5py_orbax_optax():
    mods = _port_modules()
    assert len(mods) >= 20
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'jaxlib', 'h5py', 'orbax', 'optax', 'dycon_paper_replication_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.startswith('jax') and v is not None for k, v in sys.modules.items())\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_names_nothing_of_the_jax_package():
    files = (list(PORT.rglob("*.py")) + list(PORT.rglob("*.cu")) + list(PORT.rglob("*.cuh"))
             + [REPO / "chip_smoke.py"])
    for path in files:
        text = path.read_text()
        for needle in ("dycon_paper_replication_tpu.", "import jax", "from jax"):
            assert needle not in text, f"{path}: {needle}"


def test_kernel_wrapper_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k1 = folded_conv_cuda.FoldedConv3()
    x = torch.zeros(1, 2, 2, 2, 8)
    wf = torch.zeros(2, 2, 2, 8, 128)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        k1.launch(x, wf, to_phase=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        k1(x.to("meta"), wf.to("meta"), to_phase=1)
    assert k1.launches == 0
    # a CPU tensor takes the plain version and counts no launch
    assert k1(x, wf, to_phase=1).shape == (1, 3, 3, 3, 128)
    assert k1.launches == 0


def test_dw_wrapper_and_autograd_function_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dw = folded_conv_cuda.FoldedConv3Dw()
    x = torch.zeros(1, 2, 2, 2, 8)
    dy = torch.zeros(1, 3, 3, 3, 128)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dw.launch(x, dy, to_phase=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dw(x.to("meta"), dy.to("meta"), to_phase=1)
    assert dw.launches == 0
    assert dw(x, dy, to_phase=1).shape == (2, 2, 2, 8, 128)  # CPU: the plain version
    assert dw.launches == 0
    # FoldedConv3Fn on a tensor that is not on the CPU reaches K1's launch in
    # the forward, and (the forward stubbed) K1-dW's in the backward
    xm = torch.zeros(1, 2, 2, 2, 8, device="meta")
    wf = torch.zeros(2, 2, 2, 8, 128, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        folded_conv_cuda.FoldedConv3Fn.apply(xm, wf, 1)
    monkeypatch.setattr(folded_conv_cuda, "folded_conv3",
                        lambda *a, **k: torch.zeros(1, 3, 3, 3, 128, device="meta"))
    y = folded_conv_cuda.FoldedConv3Fn.apply(xm, wf, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        y.sum().backward()


def test_trainer_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.config_from_args("pancreas", ["--snapshot_root", str(tmp_path / "runs")])
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    assert not (tmp_path / "runs").exists()


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        config.resolve_device("cuda")
    assert config.resolve_device("cpu") == torch.device("cpu")


def test_resolved_layout_keys_on_the_device():
    cfg = config.make_config("pancreas")
    assert cfg.resolved_layout("cuda") == "folded"
    assert cfg.resolved_layout("cpu") == "NDHWC"
    assert config.make_config("pancreas", layout="NDHWC").resolved_layout("cuda") == "NDHWC"


def test_k2_wrappers_and_fused_fecl_raise_without_cuda(monkeypatch):
    """The fused FeCL on a tensor that is not on the CPU reaches K2's
    forward launch, and (the forward stubbed) K2's backward launch: both
    raise, and neither falls back to the plain twin."""
    from dycon_paper_replication_tpu_torch.ops import fecl_fused

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feat = torch.zeros(1, 64, 64, device="meta", requires_grad=True)
    mask = torch.zeros(1, 64, device="meta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fecl_fused.fecl_loss_fused(feat, mask)
    assert fecl_fused.fecl_fwd.launches == 0
    monkeypatch.setattr(fecl_fused, "fecl_fwd",
                        lambda f, *a: tuple(torch.zeros(1, 64, device="meta") for _ in range(7)))
    loss = fecl_fused.fecl_loss_fused(feat, mask)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loss.backward()
    assert fecl_fused.fecl_bwd.launches == 0


def test_isles_trainer_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.config_from_args("isles22", ["--snapshot_root", str(tmp_path / "runs")])
    assert (cfg.device, cfg.fecl_chunk, cfg.fecl_impl) == ("cuda", 512, "fused")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    assert not (tmp_path / "runs").exists()
