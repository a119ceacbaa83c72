"""The NaN/Inf skip, decided on the device, against the JAX package, on the CPU.

Tolerances, stated before the first run:
  * (c) a synthetic Pancreas tree of 6 + 1 cases of (40, 40, 24) whose
    labeled case PANCREAS_0000 holds NaN in every voxel of its image, so
    that every batch that draws it has a NaN loss; labelnum 4, patch
    (32, 32, 16), batch 2 of which 1 labeled, 8 iterations at val_every 8
    (hd95_every 2), one device, validation replaced by 0.0 and the
    consistency weight of iteration i by 0.001 (i + 1) on both sides. Each
    package's Trainer runs at fetch_ahead 0 and at 1 (step_diagnostics
    "cadence"), each from its own initial weights at the seed, drawing its
    own teacher noise and dropout masks (JAX's streams, ops/threefry.py;
    each step's key equal to the JAX step's), with the JAX step's kink
    sides shared as in tests/test_torch_ablation.py (but on the skipped
    steps, where the shared ReLU sides would zero the NaN);
    the JAX light step is its full step with the diagnostic outputs
    dropped (one compile). Equal, at each setting: the number of dispatched
    steps, which of them were skipped (at least one), which were light,
    the four host scalars of every dispatched step in float32 (the
    consistency weight computed one iteration ahead after a skip at
    fetch_ahead 1 included), the iterations of train/HD95 and of the
    similarity monitor, the final step count. Within rtol 1e-5 + atol 1e-6:
    every applied step's 8 scalars. The final state within
    tests/test_torch_train_step.py's path-scaled tolerances, over the
    applied steps' momentum;
  * (d) the on-device skip against the JAX step (tests/test_train.py's
    test_nan_guard_skips_update): a batch with one NaN voxel from the same
    state: both skip; the port's student, momentum, teacher parameters,
    student running stats and step are bit-equal to the state before (so
    to the JAX step's, which keeps them too), its teacher running stats
    advance as JAX's do (within 1e-4 relative + 1e-5, NaN where JAX's are);
    the step count is a device tensor that a healthy step then advances.
    The EMA alpha computed from a device step count is bit-equal to JAX's
    traced float32 value at steps 0..20000, and the poly learning rate
    within 2.5e-9 absolute (2.5e-7 of base_lr 0.01): XLA's CPU code for
    1 - s / max_iterations rounds otherwise than IEEE division (torch's and
    numpy's) at a third of the steps, by one float32 ulp, which the 0.9
    power carries to at most 1.9e-9 near the end of the schedule.
"""

import contextlib
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dycon_paper_replication_tpu import config as jconfig
from dycon_paper_replication_tpu.train import trainer as jtrainer
from dycon_paper_replication_tpu_torch import config as tconfig
from dycon_paper_replication_tpu_torch import weights
from dycon_paper_replication_tpu_torch.data import synthetic
from dycon_paper_replication_tpu_torch.models import UNet3DConfig
from dycon_paper_replication_tpu_torch.ops import ramps
from dycon_paper_replication_tpu_torch.train import trainer as ttrainer
from dycon_paper_replication_tpu_torch.train.device_check import KinkSides
from dycon_paper_replication_tpu_torch.train.step import (
    SCALAR_METRICS,
    StepScalars,
    build_train_step,
    ema_alpha,
)
from test_torch_train_step import _compare_states, _np, _words
from test_torch_vnet_train import _JaxKinkSides

torch.set_num_threads(1)
PATCH = (32, 32, 16)
STEPS = 8
NAN_CASE = "PANCREAS_0000"
SKIPPED = SCALAR_METRICS.index("skipped")


def _nan_tree(root):
    synthetic.make_pancreas(root, n_train=6, n_test=1, shape=(40, 40, 24), seed=1)
    import h5py

    path = os.path.join(root, "Pancreas_data", NAN_CASE + ".h5")
    with h5py.File(path) as f:
        image, label = f["image"][:], f["label"][:]
    synthetic.write_case(path, np.full_like(image, np.nan), label)


def _kw(root, snapshots, fetch_ahead):
    return dict(root_dir=root, snapshot_root=snapshots, patch_size=PATCH, batch_size=2,
                labeled_bs=1, labelnum=4, max_iterations=STEPS, val_every=STEPS, save_every=100,
                fetch_ahead=fetch_ahead, data_parallel=1)


def _logged_steps(snapshot, tag):
    with open(os.path.join(snapshot, "metrics.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if r["tag"] == tag]


def _abs_max(opt_state):
    """The optimizer state with each leaf replaced by its max |.|, all that
    _compare_states reads of a state before the last."""
    return types.SimpleNamespace(opt_state=jax.tree.map(lambda v: np.abs(np.asarray(v)).max(),
                                                        opt_state))


def _weight(iter_num):
    """A consistency weight that moves every iteration on both sides (the
    packages' own is flat over the first 150), so that the weight a step was
    dispatched with names the iteration it was computed for."""
    return 0.001 * (iter_num + 1)


@pytest.fixture(scope="module")
def nan_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nan")
    root = str(tmp / "Pancreas")
    _nan_tree(root)
    recorded = _JaxKinkSides()
    out = {}
    real_full = None
    with pytest.MonkeyPatch.context() as mp, contextlib.ExitStack() as stack:
        monitored = {"jax": [], "port": []}
        mp.setattr(jtrainer, "monitor_similarity_distributions",
                   lambda f, m, it, p: monitored["jax"].append(it))
        mp.setattr(ttrainer, "monitor_similarity_distributions",
                   lambda f, m, it, p: monitored["port"].append(it))
        for patch in recorded.patches():
            stack.enter_context(patch)
        for fa in (0, 1):
            run = dict(jax_steps=[], port_steps=[])
            jt = jtrainer.Trainer(jconfig.make_config(
                "pancreas", **_kw(root, str(tmp / f"jax{fa}"), fa)))
            js0 = jax.tree.map(np.array, jt.state)
            jt.validate = lambda: 0.0
            jt._consistency_weight = _weight
            real_full = real_full or jt.train_step  # one compile for both runs

            def jax_wrap(light, run=run):
                def jax_step(state, batch, key, scalars):
                    n_relu, n_pool = len(recorded.relu), len(recorded.pool)
                    new_state, m = real_full(state, batch, key, scalars)
                    jax.effects_barrier()
                    run["jax_steps"].append(dict(
                        key=key, light=light, vec=np.array(m["scalars"]),
                        scalars=[np.float32(s) for s in scalars],
                        relu=(n_relu, len(recorded.relu)), pool=(n_pool, len(recorded.pool)),
                        fg=np.unpackbits(np.array(m["pred_fg_bits"]), axis=-1,
                                         bitorder="little")[..., :PATCH[2]].astype(bool),
                        opt=_abs_max(new_state.opt_state)))
                    return new_state, ({"scalars": m["scalars"]} if light else m)
                return jax_step

            jt.train_step, jt.train_step_light = jax_wrap(False), jax_wrap(True)
            jt.run()
            run.update(jax_state=_np(jt.state), js0=js0, jax_snapshot=jt.snapshot_path)

            pcfg = tconfig.make_config("pancreas", device="cpu",
                                       **_kw(root, str(tmp / f"port{fa}"), fa))
            port = ttrainer.Trainer(pcfg)
            port.validate = lambda: 0.0
            port._consistency_weight = _weight

            def port_wrap(real, light, run=run):
                def port_step(state, batch, key, scalars):
                    rec = run["jax_steps"][len(run["port_steps"])]
                    sides = KinkSides.given(recorded.relu[slice(*rec["relu"])],
                                            recorded.pool[slice(*rec["pool"])], [],
                                            [torch.from_numpy(rec["fg"])])
                    # a skipped step runs on its own: the shared sides would
                    # zero the NaN at the ReLUs
                    shared = contextlib.nullcontext() if rec["vec"][SKIPPED] else sides.share()
                    with shared:
                        vec, diag = real(state, batch, key, scalars)
                    run["port_steps"].append(dict(light=light, vec=vec.numpy().copy(),
                                                  key=np.asarray(key),
                                                  scalars=[np.float32(s) for s in scalars]))
                    return vec, diag
                return port_step

            port.train_step, port.train_step_light = (port_wrap(port.train_step, False),
                                                      port_wrap(port.train_step_light, True))
            port.run()
            run.update(port=port, port_snapshot=port.snapshot_path,
                       monitored={k: list(v) for k, v in monitored.items()})
            out[fa] = run
    out["real_full"], out["pcfg"] = real_full, pcfg
    return out


@pytest.mark.parametrize("fa", [0, 1])
def test_nan_schedule_matches_jax(nan_runs, fa):
    run = nan_runs[fa]
    jax_steps, port_steps = run["jax_steps"], run["port_steps"]
    assert len(port_steps) == len(jax_steps)
    skipped = [bool(r["vec"][SKIPPED]) for r in jax_steps]
    assert [bool(r["vec"][SKIPPED]) for r in port_steps] == skipped and any(skipped)
    assert [r["light"] for r in port_steps] == [r["light"] for r in jax_steps]
    for i, (got, want) in enumerate(zip(port_steps, jax_steps)):
        assert got["scalars"] == want["scalars"], i
        np.testing.assert_array_equal(got["key"], _words(want["key"]), err_msg=str(i))
        if not skipped[i]:
            np.testing.assert_allclose(got["vec"], want["vec"], rtol=1e-5, atol=1e-6,
                                       err_msg=str(i))
    for tag in ("train/HD95", "info/loss"):
        assert _logged_steps(run["port_snapshot"], tag) == _logged_steps(run["jax_snapshot"], tag)
    assert run["monitored"]["port"] == run["monitored"]["jax"]
    port = run["port"]
    assert int(port.state.step) == int(run["jax_state"].step) == len(skipped) - sum(skipped)
    applied = [r["opt"] for r, bad in zip(jax_steps, skipped) if not bad]
    _compare_states(port.state, applied[:-1] + [run["jax_state"]], run["js0"],
                    nan_runs["pcfg"].base_lr)


def test_fetch_ahead_deviations_after_a_skip(nan_runs):
    """The deviations JAX's config documents, and no others (both packages
    alike, by test_nan_schedule_matches_jax): at fetch_ahead 0 every step is
    dispatched with the weight of the iteration it lands on; at 1 the step
    queued behind a skipped one took the weight of the iteration after, and
    at least one step did. The applied steps are the same at both settings."""
    off = {}
    for fa in (0, 1):
        steps, applied, off[fa] = nan_runs[fa]["jax_steps"], 0, []
        for i, rec in enumerate(steps):
            if rec["scalars"][1] != np.float32(_weight(applied)):
                assert fa == 1 and steps[i - 1]["vec"][SKIPPED], (fa, i)
                assert rec["scalars"][1] == np.float32(_weight(applied + 1)), (fa, i)
                off[fa].append(i)
            applied += not rec["vec"][SKIPPED]
    hd95 = {fa: _logged_steps(nan_runs[fa]["jax_snapshot"], "train/HD95") for fa in (0, 1)}
    print("steps dispatched ahead", off, "train/HD95 at", hd95)
    assert off[0] == [] and off[1]
    assert set(hd95[1]) <= set(hd95[0])


# ---------------------------------------------------------------- (d)


def test_on_device_skip_matches_jax(nan_runs):
    run, real_full = nan_runs[0], nan_runs["real_full"]
    js0, pcfg = run["js0"], nan_runs["pcfg"]
    rng = np.random.default_rng(4)
    label = (rng.random((2, *PATCH)) > 0.6).astype(np.int32)
    image = (0.4 * label + 0.1 * rng.standard_normal(label.shape)).astype(np.float32)[..., None]
    image[0, 0, 0, 0, 0] = np.nan
    batch = {"image": image, "label": label}
    key, scalars = jax.random.key(5), (5.0, 0.01, 1.3, 0.3)
    from dycon_paper_replication_tpu.train.step import StepScalars as JaxScalars

    new_js, m = real_full(jax.tree.map(jnp.array, js0), {k: jnp.asarray(v) for k, v in
                                                         batch.items()}, key,
                          JaxScalars.make(*scalars))
    new_js = _np(new_js)
    assert float(np.asarray(m["scalars"])[SKIPPED]) == 1.0 and int(new_js.step) == 0

    cfg_net = UNet3DConfig(layout=pcfg.resolved_layout("cpu"))
    port = weights.jax_train_state_to_torch(js0, cfg_net)
    before = weights.jax_train_state_to_torch(js0, cfg_net)
    assert port.step.dtype == torch.int64 and port.step.dim() == 0
    step = build_train_step(pcfg, lambda s: pcfg.base_lr)
    vec, _ = step(port, {k: torch.from_numpy(v) for k, v in batch.items()}, _words(key),
                  StepScalars(*scalars))
    assert float(vec[SKIPPED]) == 1.0 and int(port.step) == 0
    for name, got, want in (
            ("student", port.student.state_dict(), before.student.state_dict()),
            ("momentum", port.momentum, before.momentum),
            ("teacher", dict(port.teacher.named_parameters()),
             dict(before.teacher.named_parameters()))):
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    back = weights.torch_train_state_to_jax(port, js0)
    for got, want in zip(jax.tree.leaves(back.params), jax.tree.leaves(new_js.params)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(jax.tree.leaves(back.teacher_state), jax.tree.leaves(new_js.teacher_state)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert any(not np.array_equal(a, b, equal_nan=True) for a, b in
               zip(jax.tree.leaves(back.teacher_state), jax.tree.leaves(js0.teacher_state)))
    batch["image"][0, 0, 0, 0, 0] = 0.0
    step(port, {k: torch.from_numpy(v) for k, v in batch.items()}, _words(key),
         StepScalars(*scalars))
    assert int(port.step) == 1


def test_lr_and_ema_alpha_match_jax():
    steps = np.arange(0, 20001)
    max_iter, base = 20000, 0.01
    want_poly = jax.jit(lambda s: base * (1.0 - s / max_iter) ** 0.9)(jnp.asarray(steps, jnp.int32))
    got_poly = ramps.poly_lr(base, torch.from_numpy(steps), max_iter)
    assert got_poly.dtype == torch.float32
    np.testing.assert_allclose(got_poly.numpy(), np.asarray(want_poly), rtol=0, atol=2.5e-9)
    want_alpha = jax.jit(lambda s: jnp.minimum(1.0 - 1.0 / (s.astype(jnp.float32) + 1.0), 0.99))(
        jnp.asarray(steps, jnp.int32))
    got_alpha = ema_alpha(torch.from_numpy(steps), 0.99)
    assert got_alpha.dtype == torch.float32
    np.testing.assert_array_equal(got_alpha.numpy(), np.asarray(want_alpha))

