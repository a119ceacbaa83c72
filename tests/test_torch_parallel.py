"""The port's data parallelism (parallel/mesh.py, the data-parallel step and
trainer) on the CPU: ranks are spawned processes joined by gloo over a file
store, one intra-op thread each; every spawning test has its own timeout
(parallel.launch kills ranks still running then and raises).

  * `Trainer._apply_multi_device_rules` against the JAX trainer's on the
    cases of tests/test_train.py's TestMultiDeviceTrainerRules: the same
    config and the same notes; `make_mesh`'s clamps and a Shard's rows;
  * one 2-rank step against the 1-process step on the same global batch,
    threefry key (so the same teacher noise and dropout masks, each rank
    drawing its rows of the global draw) and state, each rank taking its
    rows of the 1-process step's kink sides (ReLUs, max pools, the row-tiled
    FeCL's embeddings) within train/device_check.py's margin: with the
    masks of key 5 a ReLU input of the VNet's within float32 noise of 0 took
    the other side in a rank and moved enc0.conv0.w's momentum to 7.4x the
    tolerance below (keys 0-4: 0.05-0.65x); a folded UNet3D (dropout
    0.3, BatchNorm in its projection head) and a folded VNet (dropout 0.5,
    train-mode BatchNorm everywhere), both at a tiny width, and the UNet3D
    again without gradient clipping (which would hide a wrong gradient
    scale), with tests/test_train.py's DP tolerances: loss rtol 2e-5,
    parameters, teacher, momentum and running stats atol 1e-5 + rtol 1e-4;
    at the same tolerances, the shard paths that the Pancreas UNet3D does
    not reach: the ISLES step config with `fecl_chunk` 96 under
    `fecl_impl` "chunked" and "fused" (the row-tiled FeCL's global batch
    and cross count; the fused one through its CPU twin), the UNet3D with
    ASPP (its pooled BatchNorm over the global batch); and the UNet3D in
    bfloat16 at the bfloat16 step rule (its test's doc says why);
  * the same 2-rank step against the JAX step on a 2-device CPU mesh (the
    batch sharded over conftest's virtual devices): the full-width folded
    UNet3D of tests/test_torch_train_step.py, its case and its tolerances
    (the JAX step's key handed to the port, which draws the same noise from
    it; no kink sides to share there);
  * `train_pancreas --data_parallel 2` for 2 iterations against
    `--data_parallel 1` (its base_lr halved, which the multi-device rules
    double back): the same logged losses, one log and one set of
    checkpoints, written by rank 0.
"""

import json
import os

import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import parallel, weights
from dycon_paper_replication_tpu_torch.data import synthetic
from dycon_paper_replication_tpu_torch.models import UNet3DConfig, VNetConfig, build_model
from dycon_paper_replication_tpu_torch.ops import threefry
from dycon_paper_replication_tpu_torch.train import trainer as ttrainer
from dycon_paper_replication_tpu_torch.train.device_check import KinkSides
from dycon_paper_replication_tpu_torch.train.state import TrainState, create_train_state
from dycon_paper_replication_tpu_torch.train.step import (
    SCALAR_METRICS,
    StepScalars,
    build_train_step,
)

torch.set_num_threads(1)
SPAWN_TIMEOUT = 300  # seconds for one spawned run, start-up included
PATCH = (32, 32, 16)
B, LBS = 4, 2
SCALARS = (5.0, 0.1 * np.exp(-5.0), 1.3, 0.3)
ISLES_SCALARS = SCALARS[:3] + (0.05,)


def _batch(seed):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in PATCH], indexing="ij"), -1)
    labels = []
    for _ in range(B):
        center = rng.uniform(0.3, 0.7, 3) * PATCH
        radii = rng.uniform(0.3, 0.5, 3) * PATCH
        labels.append((((grid - center) / radii) ** 2).sum(-1) <= 1.0)
    label = np.stack(labels).astype(np.int32)
    image = (0.4 * label + 0.1 * rng.standard_normal(label.shape)).astype(np.float32)[..., None]
    return {"image": image, "label": label}


def _case(net_cfg, seed, dataset="pancreas", scalars=SCALARS, **cfg):
    """A step's inputs: the model config, a seeded initial state, the global
    batch, the step's threefry key (the step draws its noise from it), the
    dataset's step config with TrainConfig overrides, and the step
    scalars."""
    params, mstate = weights.init_jax_tree(net_cfg, seed=seed)
    student = build_model(net_cfg)
    student.load_state_dict(weights.jax_tree_to_state_dict(params, mstate))
    return dict(net_cfg=net_cfg, state=_state_dicts(create_train_state(student)),
                batch=_batch(seed), key=threefry.key(5), cfg=cfg, dataset=dataset,
                scalars=scalars)


def _state_dicts(state: TrainState) -> dict:
    return dict(student={k: v.clone() for k, v in state.student.state_dict().items()},
                teacher={k: v.clone() for k, v in state.teacher.state_dict().items()},
                momentum={k: v.clone() for k, v in state.momentum.items()}, step=state.step)


def _train_state(net_cfg, sd: dict) -> TrainState:
    student = build_model(net_cfg)
    if net_cfg.compute_dtype == torch.float64:  # the bf16 case's yardstick, all in float64
        student = student.to(torch.float64)
        sd = dict(sd, momentum={k: v.double() for k, v in sd["momentum"].items()})
    student.load_state_dict(sd["student"])
    state = create_train_state(student)
    state.teacher.load_state_dict(sd["teacher"])
    state.momentum = {k: v.clone() for k, v in sd["momentum"].items()}
    state.step = sd["step"]
    return state


def _run_steps(cases: dict, shard, sides: dict | None = None) -> dict:
    """One step of each case, on this rank's rows with `shard`. Without
    `sides` the step's kink sides (ReLUs, max pools, the row-tiled FeCL's
    embeddings: train/device_check.py's KinkSides) are recorded and returned;
    with the 1-process step's, the step takes this rank's rows of them
    within that margin."""
    out = {}
    for name, case in cases.items():
        state = _train_state(case["net_cfg"], case["state"])
        cfg = tconfig.make_config(case.get("dataset", "pancreas"), patch_size=PATCH,
                                  batch_size=B, labeled_bs=LBS, device="cpu",
                                  **case.get("cfg", {}))
        step = build_train_step(cfg, lambda s: cfg.base_lr, shard)
        batch = parallel.shard_batch(shard, case["batch"])
        if sides is None:
            kinks = KinkSides()
            context = kinks.record()
        else:
            relu, pool, fecl = sides[name]
            rows = list(shard.rows)
            kinks = KinkSides.given([r[rows] for r in relu], [p[rows] for p in pool],
                                    [(f[rows], None if t is None else t[rows]) for f, t in fecl])
            context = kinks.share()
        with context:
            vec, _ = step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                          case["key"], StepScalars(*case.get("scalars", SCALARS)))
        out[name] = dict(vec=vec.numpy(), state=_state_dicts(state),
                         sides=(kinks._relu, kinks._pool, kinks._fecl))
    return out


def _rank_steps(rank, world, device, cases, sides):
    return _run_steps(cases, parallel.Shard(rank, world, B, LBS), sides)


def _assert_states_close(got: dict, want: dict):
    assert got["step"] == want["step"] == 1
    for part in ("student", "teacher", "momentum"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            np.testing.assert_allclose(got[part][k].numpy(), want[part][k].numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=f"{part} {k}")


@pytest.fixture(scope="module")
def jax_case():
    """tests/test_torch_train_step.py's case: the JAX model (full-width
    folded UNet3D, dropout 0), config, step and state (key 11), its first
    batch and the JAX step's key 21."""
    import jax

    from dycon_paper_replication_tpu import config as jconfig
    from dycon_paper_replication_tpu.models.factory import Model
    from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxNetConfig
    from dycon_paper_replication_tpu.models.unet3d import init_unet3d, unet3d_apply
    from dycon_paper_replication_tpu.train.state import create_train_state as jax_state
    from dycon_paper_replication_tpu.train.state import make_optimizer
    from dycon_paper_replication_tpu.train.step import build_train_step as jax_build_step
    from test_torch_train_step import _batch as step_batch

    model = Model(JaxNetConfig(dropout_rate=0.0, layout="folded"), init_unet3d, unet3d_apply)
    cfg = jconfig.make_config("pancreas", patch_size=PATCH, batch_size=B, labeled_bs=LBS)
    optimizer = make_optimizer(lambda step: cfg.base_lr, cfg.momentum, cfg.weight_decay,
                               cfg.grad_clip_norm)
    js0 = jax_state(model, jax.random.key(11), optimizer)
    step = jax.jit(jax_build_step(model, optimizer, cfg, diagnostics=False))
    key = jax.random.key(21)
    batch = step_batch(1)
    return dict(cfg=cfg, step=step, js0=js0, key=key, batch=batch)


@pytest.fixture(scope="module")
def spawned(jax_case):
    """The three cases, each one step in 2 spawned ranks and in this
    process on one rank."""
    import jax

    js0 = jax.tree.map(np.asarray, jax_case["js0"])
    full = UNet3DConfig(dropout_rate=0.0, layout="folded")
    cases = {
        "unet": _case(UNet3DConfig(feature_scale=16, proj_hidden=32, proj_out=16,
                                   layout="folded"), 3),
        # no clipping: the update then shows the gradient's scale (the
        # all-reduce must sum the ranks' gradients, not average them)
        "unet_unclipped": _case(UNet3DConfig(feature_scale=16, proj_hidden=32, proj_out=16,
                                             layout="folded"), 3, grad_clip_norm=1e9),
        "vnet": _case(VNetConfig(n_filters=4, proj_hidden=32, proj_out=16, layout="folded"), 4),
        # the row-tiled FeCL under the ISLES step config: 8 x 8 x 4 = 256 rows
        # at projection scale 4, in tiles of 96 (the last padded); its cross
        # term's global count of hard pairs, with neg_thresh 0.05 so that it
        # has pairs (train/device_check.py, SCALARS_ISLES)
        **{f"isles_{impl}": _case(
            UNet3DConfig(feature_scale=16, proj_hidden=32, proj_out=16, scale_factor=4,
                         layout="folded"), 6, dataset="isles22", scalars=ISLES_SCALARS,
            fecl_chunk=96, fecl_impl=impl) for impl in ("chunked", "fused")},
        # ASPP's pooled BatchNorm, which takes its statistics over the global batch
        "aspp": _case(UNet3DConfig(feature_scale=16, proj_hidden=32, proj_out=16,
                                   use_aspp=True, layout="folded"), 7, use_aspp=True),
        **{name: _case(UNet3DConfig(feature_scale=16, proj_hidden=32, proj_out=16,
                                    layout="folded", compute_dtype=dtype), 3,
                       compute_dtype="bfloat16")
           for name, dtype in (("unet_bf16", torch.bfloat16), ("unet_bf16_f64", torch.float64))},
        "jax": dict(net_cfg=full, state=_state_dicts(weights.jax_train_state_to_torch(js0, full)),
                    batch=jax_case["batch"], key=np.asarray(jax.random.key_data(jax_case["key"]))),
    }
    ranked = {k: v for k, v in cases.items() if not k.endswith("_f64")}  # 1 process only
    one = _run_steps(cases, None)
    sides = {name: one[name].pop("sides") for name in ranked}
    two = parallel.launch(_rank_steps, 2, args=(ranked, sides), threads=1,
                          timeout=SPAWN_TIMEOUT)
    return cases, one, two


@pytest.mark.parametrize("name", ["unet", "unet_unclipped", "vnet", "isles_chunked",
                                  "isles_fused", "aspp"])
def test_two_ranks_match_one(spawned, name):
    _, one, two = spawned
    got, want = two[name], one[name]
    assert got["vec"][SCALAR_METRICS.index("skipped")] == 0
    np.testing.assert_allclose(got["vec"][0], want["vec"][0], rtol=2e-5)
    np.testing.assert_allclose(got["vec"], want["vec"], rtol=2e-5, atol=1e-6)
    _assert_states_close(got["state"], want["state"])


def test_two_ranks_match_one_bf16(spawned):
    """The bfloat16 case at the bfloat16 step rule of the card-against-CPU
    check (train/device_check.py: `comparisons` raised by `bf16_comparisons`
    to 4 x each leaf's difference between the 1-process step and the same
    step in float64). The float32 tolerances above do not hold a bfloat16
    step split over ranks, in either package: each rank's conv weight
    gradients are bfloat16 sums rounded before the cross-rank sum, and for
    a weight in front of a norm those partials largely cancel. Run at them
    first, the port's 2 ranks differed from 1 process by up to 7.5 %
    (1.9e-4) in conv1.conv1.w's momentum; the JAX step in bfloat16 on a
    2-device CPU mesh against 1 device, on this case's model (dropout 0)
    and batch, fails them at 39 of 48 momentum leaves (up to 1.0e-2, conv1.conv1.b)."""
    from dycon_paper_replication_tpu_torch.train.device_check import (
        _lines, bf16_comparisons, comparisons, worst_by_group)

    cases, one, two = spawned
    net_cfg = cases["unet_bf16"]["net_cfg"]
    got = _train_state(net_cfg, two["unet_bf16"]["state"])
    want = _train_state(net_cfg, one["unet_bf16"]["state"])
    ref = _train_state(cases["unet_bf16_f64"]["net_cfg"], one["unet_bf16_f64"]["state"])
    label, lr = cases["unet_bf16"]["batch"]["label"], tconfig.make_config("pancreas").base_lr
    got_vec, want_vec = two["unet_bf16"]["vec"], one["unet_bf16"]["vec"]
    assert got_vec[SCALAR_METRICS.index("skipped")] == 0
    rows = bf16_comparisons(
        comparisons(got, got_vec, want, want_vec, label, lr),
        comparisons(want, want_vec, ref, one["unet_bf16_f64"]["vec"], label, lr), want_vec)
    print(f"worst leaf by group (difference / tolerance): {worst_by_group(rows)}")
    assert _lines(rows, got, want) == []


def test_two_ranks_match_jax_mesh(spawned, jax_case):
    """The 2-rank step against the JAX step with its batch sharded over a
    2-device mesh, at tests/test_torch_train_step.py's tolerances."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from test_torch_train_step import _compare_states
    from dycon_paper_replication_tpu.train.step import StepScalars as JaxScalars

    cases, _, two = spawned
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    rep, shd = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    js = jax.device_put(jax_case["js0"], rep)
    batch = {k: jax.device_put(v, shd) for k, v in jax_case["batch"].items()}
    new_js, metrics = jax_case["step"](js, batch, jax.device_put(jax_case["key"], rep),
                                       JaxScalars.make(*SCALARS))
    want = np.asarray(metrics["scalars"])
    got = two["jax"]["vec"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    port = _train_state(cases["jax"]["net_cfg"], two["jax"]["state"])
    _compare_states(port, [jax.tree.map(np.asarray, new_js)],
                    jax.tree.map(np.asarray, jax_case["js0"]), jax_case["cfg"].base_lr)


@pytest.mark.parametrize("bs,lbs,n", [(10, 5, 4), (10, 5, 1), (8, 4, 8), (8, 4, 2)])
def test_multi_device_rules_match_jax(bs, lbs, n):
    from dycon_paper_replication_tpu import config as jconfig
    from dycon_paper_replication_tpu.train.trainer import Trainer as JaxTrainer

    jcfg = jconfig.make_config("pancreas", batch_size=bs, labeled_bs=lbs, base_lr=0.01)
    tcfg = tconfig.make_config("pancreas", batch_size=bs, labeled_bs=lbs, base_lr=0.01)
    try:
        want, want_notes = JaxTrainer._apply_multi_device_rules(jcfg, n)
    except ValueError as exc:
        with pytest.raises(ValueError, match="round to zero"):
            ttrainer.Trainer._apply_multi_device_rules(tcfg, n)
        assert "round to zero" in str(exc)
        return
    got, notes = ttrainer.Trainer._apply_multi_device_rules(tcfg, n)
    assert notes == want_notes
    assert (got.batch_size, got.labeled_bs, got.base_lr) == (
        want.batch_size, want.labeled_bs, want.base_lr)
    if n == 1:
        assert got is tcfg and notes == []


def test_make_mesh_and_rows():
    assert parallel.make_mesh(0, "cpu", 8, 4) == 1
    assert parallel.make_mesh(3, "cpu") == 3  # processes on the CPU are not clamped
    shard = parallel.Shard(1, 2, 8, 4)
    assert (shard.labeled, shard.unlabeled, shard.batch) == (2, 2, 4)
    np.testing.assert_array_equal(shard.rows, [2, 3, 6, 7])
    rows = np.concatenate([parallel.Shard(r, 2, 8, 4).rows for r in range(2)])
    assert sorted(rows) == list(range(8))
    assert parallel.eval_devices("cpu", 1) is None
    assert parallel.eval_devices("cpu", 2) == [torch.device("cpu")] * 2
    assert tconfig.config_from_args("pancreas", ["--data_parallel", "2"]).data_parallel == 2
    for bad in (["--data_parallel", "-1"], ["--gpu_ids", "0,1"], ["--use_ddp", "1"]):
        with pytest.raises(SystemExit):
            tconfig.config_from_args("pancreas", bad)


def _losses(snapshot):
    rows = [json.loads(line) for line in open(os.path.join(snapshot, "metrics.jsonl"))]
    return {(r["step"], r["tag"]): r["value"] for r in rows if r["tag"].startswith("info/loss")}


def test_train_cli_data_parallel_2_matches_1(tmp_path):
    root = str(tmp_path / "Pancreas")
    synthetic.make_pancreas(root, n_train=4, n_test=1, shape=(24, 24, 20), suffix=".npz")
    runs = {}
    for n, lr in ((1, "0.01"), (2, "0.005")):
        argv = ["--device", "cpu", "--root_dir", root, "--snapshot_root", str(tmp_path / f"r{n}"),
                "--patch_size", "16", "16", "16", "--batch_size", "4", "--labeled_bs", "2",
                "--labelnum", "2", "--max_iterations", "2", "--val_every", "2",
                "--save_every", "2", "--base_lr", lr, "--data_parallel", str(n)]
        cfg = tconfig.config_from_args("pancreas", argv)
        best = ttrainer.train(cfg, threads=1, timeout=SPAWN_TIMEOUT)
        snapshot = cfg.snapshot_path()
        runs[n] = (best, _losses(snapshot), sorted(os.listdir(snapshot)), snapshot)
    (best1, loss1, files1, snap1), (best2, loss2, files2, snap2) = runs[1], runs[2]
    assert loss1.keys() == loss2.keys() and len(loss1) >= 2
    for k in loss1:
        np.testing.assert_allclose(loss2[k], loss1[k], rtol=2e-5, err_msg=str(k))
    assert files1 == files2 and "iter_2.pt" in files2
    log = open(os.path.join(snap2, "log.txt")).read()
    assert log.count("Iteration 2 : Loss") == 1  # rank 0 alone logs
    assert "Scaled learning rate to 0.01 for 2 devices" in log
