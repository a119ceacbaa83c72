"""The SSL ablation on the port (scripts/ssl_ablation_torch.py) against the
JAX package's (scripts/exp_ssl_ablation.py), on the CPU.

Tolerances, stated before the first run:
  * the hard task: the port's make_hard_pancreas (as .npz, and as .h5)
    against JAX's (.h5, h5py) at seed 7 on 2 + 1 cases of (32, 32, 24):
    every image and label bit-equal, with the same dtype, and the list
    files naming the same cases;
  * the sup arm's step (u_weight 0, consistency 0): one JAX step and one
    port step from the same weights (weights.py) on the same batch, noise
    and kink sides as tests/test_torch_train_step.py (a full-width folded
    UNet3D, patch (32, 32, 16), batch 4 of which 2 labeled, dropout 0):
    the 8 scalars within rtol 1e-5 + atol 1e-6, the state within that
    test's path-scaled tolerances; on both sides the total loss equals
    loss_ce + loss_dice in float32 exactly, while FeCL and UnCL are
    nonzero and finite; and a port step with other UnCL and FeCL scalars
    (beta, thresholds) gives a bit-identical student and momentum: those
    terms carry no gradient;
  * a short trajectory, 6 steps per arm (the count picked before the first
    run): each package's Trainer, built as its ablation script builds it
    (the port's config is the driver's `arm_config`; every field the two
    configs share is equal), runs on a hard tree of 6 + 1 cases of (40, 40,
    24) at patch (32, 32, 16), batch 4 of which 2 labeled, labelnum 3, from
    the JAX trainer's initial weights carried into the port. The two
    runs share the teacher noise (the JAX step's key), the dropout masks
    (drawn at the JAX step's trace, tests/test_torch_vnet_train.py's
    _SharedMasks, so the same 4 masks every step) and, per step, the JAX
    step's kink sides (ReLUs, max pools, the train Dice's foreground).
    Equal: the sampler's batch indices, every batch's arrays, the step
    count and the saved iter_6; the host schedules (beta, consistency
    weight, FeCL thresholds) equal in float32 at every step; the learning
    rate of every step, read from each side's update (p_prev - p_next) =
    lr x momentum by least squares over the first conv's weight, within
    rtol 1e-3 of each other and of base_lr (the output conv's updates, the
    leaf first chosen, are ~10 float32 ulps of its weights: both sides read
    0.009919 there); every step's 8 scalars within rtol 1e-5 +
    atol 1e-6; the state after the last step within
    tests/test_torch_train_step.py's path-scaled tolerances;
  * the driver end to end on the CPU (--iters 4 --val_every 2, a hard tree
    of 6 + 1 cases of (40, 40, 24) that it makes): both arms' JSON lines,
    then each again with its test metrics, all finite; the best and
    iter_4 checkpoints at the port's snapshot_path for those flags; and the
    same run in legs (--train_only with a time budget that stops after the
    first step, --resume auto --train_only, --test_only) reaching
    iteration 4 and its test metrics.
"""

import contextlib
import dataclasses
import importlib.util
import itertools
import json
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu.data import samplers as jsamplers
from dycon_paper_replication_tpu.models import layers as jlayers
from dycon_paper_replication_tpu.models.factory import Model
from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxNetConfig
from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
from dycon_paper_replication_tpu.train import trainer as jtrainer
from dycon_paper_replication_tpu.train.state import create_train_state, make_optimizer
from dycon_paper_replication_tpu.train.step import StepScalars as JaxScalars
from dycon_paper_replication_tpu.train.step import build_train_step as jax_build_train_step
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.data import samplers as tsamplers
from dycon_paper_replication_tpu_torch.data import synthetic
from dycon_paper_replication_tpu_torch.models import UNet3DConfig, layers
from dycon_paper_replication_tpu_torch.train import trainer as ttrainer
from dycon_paper_replication_tpu_torch.train.device_check import KinkSides
from dycon_paper_replication_tpu_torch.train.step import (
    SCALAR_METRICS,
    StepScalars,
    build_train_step,
)
from dycon_paper_replication_tpu_torch.utils import checkpoint
from test_torch_train_step import B, LBS, PATCH, _batch, _compare_states, _flat, _noise, _np
from test_torch_vnet_train import _JaxKinkSides, _SharedMasks

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_STEPS = 6
TREE = dict(n_train=6, n_test=1, shape=(40, 40, 24))
SCALAR_RTOL, SCALAR_ATOL = 1e-5, 1e-6
LR_RTOL = 1e-3
LR_LEAF = "conv1.conv1.w"  # updates ~3e-4 of its weights: float32 reads lr to ~1e-5


def _driver():
    spec = importlib.util.spec_from_file_location(
        "ssl_ablation_torch", os.path.join(REPO, "scripts", "ssl_ablation_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _copy(tree):
    return jax.tree.map(np.array, tree)


# ---------------------------------------------------------------- the hard task


@pytest.mark.parametrize("suffix", [".npz", ".h5"])
def test_hard_task_is_bit_equal(tmp_path, suffix):
    h5py = pytest.importorskip("h5py")
    from dycon_paper_replication_tpu.data import synthetic as jsynthetic

    kw = dict(n_train=2, n_test=1, shape=(32, 32, 24))
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jsynthetic.make_hard_pancreas(jroot, **kw)
    got = synthetic.make_hard_pancreas(troot, suffix=suffix, **kw)
    assert [[n.removesuffix(suffix) for n in names] for names in got] == \
        [[n.removesuffix(".h5") for n in names] for names in want]
    for name in ("train.list", "test.list", "test1.list"):
        with open(os.path.join(jroot, name)) as f:
            want_lines = f.read().replace(".h5", "")
        with open(os.path.join(troot, name)) as f:
            assert f.read().replace(suffix, "") == want_lines
    for stem in [n.removesuffix(".h5") for n in want[0] + want[1]]:
        with h5py.File(os.path.join(jroot, "Pancreas_data", stem + ".h5")) as f:
            ref = {k: f[k][:] for k in ("image", "label")}
        path = os.path.join(troot, "Pancreas_data", stem + suffix)
        if suffix == ".npz":
            case = dict(np.load(path))
        else:
            with h5py.File(path) as f:
                case = {k: f[k][:] for k in ("image", "label")}
        for k in ("image", "label"):
            assert case[k].dtype == ref[k].dtype and case[k].shape == (32, 32, 24)
            np.testing.assert_array_equal(case[k], ref[k], err_msg=f"{stem} {k}")
        assert 0 < ref["label"].sum() < ref["label"].size


# ---------------------------------------------------------------- the sup arm's step

SUP = dict(u_weight=0.0, consistency=0.0)


@pytest.fixture(scope="module")
def sup_step():
    """One JAX and one port step of the sup arm from the same weights."""
    net_cfg = JaxNetConfig(dropout_rate=0.0, layout="folded")
    model = Model(net_cfg, init_unet3d, unet3d_apply)
    jcfg = jconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS, **SUP)
    optimizer = make_optimizer(lambda step: jcfg.base_lr, jcfg.momentum, jcfg.weight_decay,
                               jcfg.grad_clip_norm)
    js0 = create_train_state(model, jax.random.key(11), optimizer)
    step = jax.jit(jax_build_train_step(model, optimizer, jcfg))
    scalars = (5.0, jcfg.consistency * np.exp(-5.0), 1.3, 0.3)
    batch, key = _batch(1), jax.random.key(21)
    recorded = _JaxKinkSides()
    with contextlib.ExitStack() as stack:
        for patch in recorded.patches():
            stack.enter_context(patch)
        js1, metrics = step(js0, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                            JaxScalars.make(*scalars))
        want = np.asarray(metrics["scalars"])
        jax.effects_barrier()
    fg = np.unpackbits(np.asarray(metrics["pred_fg_bits"]), axis=-1,
                       bitorder="little")[..., :PATCH[2]].astype(bool)
    tcfg = tconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS,
                               device="cpu", **SUP)
    port_step = build_train_step(tcfg, lambda s: tcfg.base_lr)
    cfg_net = UNet3DConfig(dropout_rate=0.0, layout="folded")

    def run(step_scalars):
        port = weights.jax_train_state_to_torch(_np(js0), cfg_net)
        sides = KinkSides.given(recorded.relu, recorded.pool, [], [torch.from_numpy(fg)])
        with sides.share():
            got, _ = port_step(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                               torch.Generator().manual_seed(0), StepScalars(*step_scalars),
                               noise=torch.tensor(_noise(key, batch["image"].shape)))
        return port, got.numpy()

    port, got = run(scalars)
    other, got_other = run((0.7, scalars[1], 1.45, 0.45))  # other UnCL and FeCL
    return dict(js0=js0, js1=js1, want=want, port=port, got=got, other=other,
                got_other=got_other, lr=jcfg.base_lr)


def test_sup_step_matches_jax(sup_step):
    got, want = sup_step["got"], sup_step["want"]
    assert got[SCALAR_METRICS.index("skipped")] == 0 == want[SCALAR_METRICS.index("skipped")]
    np.testing.assert_allclose(got, want, rtol=SCALAR_RTOL, atol=SCALAR_ATOL)
    _compare_states(sup_step["port"], [sup_step["js1"]], _np(sup_step["js0"]), sup_step["lr"])


def test_sup_step_is_its_supervised_terms(sup_step):
    """The total is loss_ce + loss_dice on both sides, exactly; UnCL and FeCL
    are computed and logged, and carry no gradient."""
    idx = {k: SCALAR_METRICS.index(k) for k in SCALAR_METRICS}
    for vec in (sup_step["got"], sup_step["want"], sup_step["got_other"]):
        vec = np.asarray(vec, np.float32)
        assert vec[idx["loss"]] == vec[idx["loss_ce"]] + vec[idx["loss_dice"]]
        for k in ("f_loss", "u_loss", "consistency_loss"):
            assert np.isfinite(vec[idx[k]]) and vec[idx[k]] != 0, k
    got, other = sup_step["got"], sup_step["got_other"]
    assert other[idx["u_loss"]] != got[idx["u_loss"]]
    assert other[idx["f_loss"]] != got[idx["f_loss"]]
    a, b = sup_step["port"], sup_step["other"]
    for (k, p), q in zip(a.student.named_parameters(), b.student.parameters()):
        assert torch.equal(p, q), k
    for k in a.momentum:
        assert torch.equal(a.momentum[k], b.momentum[k]), k


# ---------------------------------------------------------------- the trajectory


def _jax_config(root, work, arm, iters):
    """scripts/exp_ssl_ablation.py's config of one arm (its :80-106), on
    one device."""
    return jconfig.make_config(
        "pancreas", root_dir=root, snapshot_root=os.path.join(work, arm), exp=f"hard_{arm}",
        patch_size=PATCH, batch_size=B, labeled_bs=B // 2, labelnum=3, max_iterations=iters,
        val_every=100, save_every=iters, base_lr=0.01, time_budget_s=0.0,
        consistency_rampup=200.0 * iters / 20000.0, resume="", seed=1337,
        data_parallel=1, **({} if arm == "dycon" else SUP))


def _lr(p_prev, p_next, momentum):
    """The learning rate of one update p_next = p_prev - lr x momentum, by
    least squares over a leaf."""
    m = momentum.astype(np.float64).ravel()
    return float(((p_prev.astype(np.float64) - p_next).ravel() @ m) / (m @ m))


def _record_sampler(monkeypatch, cls, store):
    real = cls.__iter__

    def recorded(self):
        for batch in real(self):
            store.append(list(batch))
            yield batch

    monkeypatch.setattr(cls, "__iter__", recorded)


@pytest.fixture(scope="module", params=["sup", "dycon"])
def trajectory(request, tmp_path_factory):
    arm = request.param
    tmp = tmp_path_factory.mktemp(f"trajectory_{arm}")
    root = str(tmp / "data")
    synthetic.make_hard_pancreas(root, seed=7, suffix=".h5", **TREE)
    abl = _driver()
    args = abl.build_parser().parse_args(
        ["--iters", str(TRAJ_STEPS), "--val_every", "100", "--seed", "1337", "--device", "cpu",
         "--patch_size", *map(str, PATCH), "--root", root, "--work", str(tmp / "port")])
    pcfg = abl.arm_config(args, arm)
    jcfg = _jax_config(root, str(tmp / "jax"), arm, TRAJ_STEPS)
    masks = _SharedMasks(9)
    recorded = _JaxKinkSides()
    out = dict(arm=arm, pcfg=pcfg, jcfg=jcfg, jax_indices=[], port_indices=[], jax_steps=[],
               port_steps=[])
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as stack:
        mp.setattr(jlayers, "dropout", masks.jax)
        mp.setattr(layers, "dropout", masks.port)
        _record_sampler(mp, jsamplers.TwoStreamBatchSampler, out["jax_indices"])
        _record_sampler(mp, tsamplers.TwoStreamBatchSampler, out["port_indices"])
        for patch in recorded.patches():
            stack.enter_context(patch)

        jt = jtrainer.Trainer(jcfg)
        js0 = _copy(jt.state)
        jt.validate = lambda: 0.0
        real_jax_step = jt.train_step

        def jax_step(state, batch, key, scalars):
            n_relu, n_pool = len(recorded.relu), len(recorded.pool)
            new_state, m = real_jax_step(state, batch, key, scalars)
            jax.effects_barrier()
            last = len(out["jax_steps"]) == TRAJ_STEPS - 1
            out["jax_steps"].append(dict(
                batch={k: np.array(v) for k, v in batch.items()}, key=key,
                scalars=[np.float32(s) for s in scalars], vec=np.array(m["scalars"]),
                relu=(n_relu, len(recorded.relu)), pool=(n_pool, len(recorded.pool)),
                fg=np.unpackbits(np.array(m["pred_fg_bits"]), axis=-1,
                                 bitorder="little")[..., :PATCH[2]].astype(bool),
                state=_copy(new_state) if last else
                types.SimpleNamespace(opt_state=_copy(new_state.opt_state)),
                lr_leaf=_flat(_copy(new_state.params))[LR_LEAF]))
            return new_state, m

        jt.train_step = jt.train_step_light = jax_step
        jt.run()
        out["jax_step_count"] = int(jt.state.step)
        out["jax_snapshot"] = jt.snapshot_path
        out["n_masks"] = len(masks.masks)
        masks.queue = itertools.cycle(masks.masks)
        stack.close()  # JAX's kink recorders off before the port runs

        port = ttrainer.Trainer(pcfg)
        port.state = weights.jax_train_state_to_torch(
            js0, UNet3DConfig(layout=pcfg.resolved_layout("cpu")))
        port.validate = lambda: 0.0
        real_port_step = port.train_step

        def port_step(state, batch, generator, scalars, noise=None):
            rec = out["jax_steps"][len(out["port_steps"])]
            sides = KinkSides.given(recorded.relu[slice(*rec["relu"])],
                                    recorded.pool[slice(*rec["pool"])], [],
                                    [torch.from_numpy(rec["fg"])])
            with sides.share():
                vec, diag = real_port_step(state, batch, generator, scalars,
                                           noise=torch.tensor(_noise(rec["key"],
                                                                     batch["image"].shape)))
            out["port_steps"].append(dict(
                batch={k: v.numpy().copy() for k, v in batch.items()}, scalars=list(scalars),
                vec=vec.numpy().copy(),
                lr_leaf=state.student.state_dict()[LR_LEAF].numpy().copy(),
                momentum=state.momentum[LR_LEAF].numpy().copy()))
            return vec, diag

        port.train_step = port.train_step_light = port_step
        port.run()
    out.update(port=port, js0=js0, port_snapshot=port.snapshot_path)
    return out


def test_trajectory_configs_match(trajectory):
    """The driver builds the config the JAX script builds."""
    pcfg, jcfg = trajectory["pcfg"], trajectory["jcfg"]
    skip = {"root_dir", "snapshot_root", "device", "data_parallel"}
    shared = {f.name for f in dataclasses.fields(pcfg)} & {f.name for f in dataclasses.fields(jcfg)}
    for name in sorted(shared - skip):
        assert getattr(pcfg, name) == getattr(jcfg, name), name
    assert pcfg.root_dir == jcfg.root_dir


def test_trajectory_batches_match(trajectory):
    jax_idx, port_idx = trajectory["jax_indices"], trajectory["port_indices"]
    assert len(jax_idx) >= TRAJ_STEPS and len(port_idx) >= TRAJ_STEPS
    assert port_idx[:TRAJ_STEPS] == jax_idx[:TRAJ_STEPS]
    assert trajectory["n_masks"] == 4  # one JAX trace: teacher and student, 2 each
    assert len(trajectory["port_steps"]) == len(trajectory["jax_steps"]) == TRAJ_STEPS
    for i, (p, j) in enumerate(zip(trajectory["port_steps"], trajectory["jax_steps"])):
        assert p["batch"].keys() == j["batch"].keys()
        for k in j["batch"]:
            np.testing.assert_array_equal(p["batch"][k], j["batch"][k], err_msg=f"step {i} {k}")


def test_trajectory_schedules_match(trajectory):
    cfg = trajectory["pcfg"]
    js0 = trajectory["js0"]
    jax_prev = _flat(js0.params)[LR_LEAF]
    port_prev = jax_prev
    for i, (p, j) in enumerate(zip(trajectory["port_steps"], trajectory["jax_steps"])):
        assert [np.float32(s) for s in p["scalars"]] == j["scalars"], f"step {i}"
        if trajectory["arm"] == "sup":
            assert p["scalars"][1] == 0.0
        jax_m = _flat(next(el.trace for el in j["state"].opt_state
                           if "trace" in el._fields))[LR_LEAF]
        lr_jax = _lr(jax_prev, j["lr_leaf"], jax_m)
        lr_port = _lr(port_prev, p["lr_leaf"], p["momentum"])
        np.testing.assert_allclose([lr_port, lr_jax], cfg.base_lr, rtol=LR_RTOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(lr_port, lr_jax, rtol=LR_RTOL, err_msg=f"step {i}")
        jax_prev, port_prev = j["lr_leaf"], p["lr_leaf"]


def test_trajectory_losses_match(trajectory):
    for i, (p, j) in enumerate(zip(trajectory["port_steps"], trajectory["jax_steps"])):
        assert p["vec"][SCALAR_METRICS.index("skipped")] == 0 == \
            j["vec"][SCALAR_METRICS.index("skipped")]
        assert np.isfinite(p["vec"]).all()
        np.testing.assert_allclose(p["vec"], j["vec"], rtol=SCALAR_RTOL, atol=SCALAR_ATOL,
                                   err_msg=f"step {i + 1}")


def test_trajectory_state_matches(trajectory):
    port = trajectory["port"]
    assert port.state.step == trajectory["jax_step_count"] == TRAJ_STEPS
    assert os.path.isdir(os.path.join(trajectory["jax_snapshot"], f"iter_{TRAJ_STEPS}"))
    assert os.path.isfile(checkpoint.iter_checkpoint_path(trajectory["port_snapshot"],
                                                          TRAJ_STEPS))
    _compare_states(port.state, [j["state"] for j in trajectory["jax_steps"]],
                    trajectory["js0"], trajectory["pcfg"].base_lr)


# ---------------------------------------------------------------- the driver


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith('{"arm"')]


def _tiny_argv(tmp_path):
    return ["--device", "cpu", "--iters", "4", "--val_every", "2",
            "--n_train", str(TREE["n_train"]), "--n_test", str(TREE["n_test"]),
            "--shape", *map(str, TREE["shape"]), "--patch_size", *map(str, PATCH),
            "--root", str(tmp_path / "data"), "--work", str(tmp_path / "work")]


def _check_tested(abl, argv, lines):
    args = abl.build_parser().parse_args(argv)
    for arm in ("sup", "dycon"):
        rec = lines[arm]
        assert rec["final_iter"] == 4
        assert all(math.isfinite(rec[k]) for k in ("best_val_dice", "test_dice", "test_jaccard",
                                                    "test_hd95", "test_asd")), rec
        snapshot = abl.arm_config(args, arm).snapshot_path()
        assert os.path.isfile(checkpoint.best_checkpoint_path(snapshot, "unet_3D"))
        assert os.path.isfile(checkpoint.iter_checkpoint_path(snapshot, 4))


def test_driver_end_to_end(tmp_path, capsys):
    abl = _driver()
    argv = _tiny_argv(tmp_path)
    results = abl.main(argv)
    out = capsys.readouterr().out
    lines = _json_lines(out)
    assert [rec["arm"] for rec in lines] == ["sup", "dycon", "sup", "dycon"]
    assert "test_dice" not in lines[0] and "test_dice" in lines[2]
    assert "FINAL " + json.dumps(results) in out
    _check_tested(abl, argv, {rec.pop("arm"): rec for rec in lines[2:]})
    assert os.path.isfile(os.path.join(tmp_path, "data", "Pancreas_data", "PANCREAS_0000.npz"))


def test_driver_in_legs(tmp_path, capsys):
    abl = _driver()
    argv = _tiny_argv(tmp_path)
    first = abl.main(argv + ["--train_only", "--time_budget_s", "1e-9"])
    assert {arm: r["final_iter"] for arm, r in first.items()} == {"sup": 1, "dycon": 1}
    second = abl.main(argv + ["--train_only", "--resume", "auto"])
    assert {arm: r["final_iter"] for arm, r in second.items()} == {"sup": 4, "dycon": 4}
    third = abl.main(argv + ["--test_only"])
    assert all("final_iter" not in r and "test_dice" in r for r in third.values())
    out = capsys.readouterr().out
    assert len(_json_lines(out)) == 6
    _check_tested(abl, argv, {arm: dict(second[arm], **third[arm]) for arm in third})
