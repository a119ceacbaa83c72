#!/usr/bin/env python3
"""The JAX package's canonical full-length runs on the port, in relay legs.

    python3 scripts/canonical_run_torch.py --dataset pancreas --leg fresh --kill_at 2500
    python3 scripts/canonical_run_torch.py --dataset pancreas --leg resume --time_budget_s 3000
    python3 scripts/canonical_run_torch.py --dataset pancreas --leg test

Counterpart of scripts/exp_canonical_20k.sh + exp_canonical_20k_r5.sh
(Pancreas) and scripts/exp_brats19_endurance.sh (BraTS-2019), with their
flags. The tree is the one those runs trained on, made on the host at
`--root` when its list file is missing, as .npz cases:
  pancreas - make_pancreas(n_train=62, n_test=20, shape=(128, 128, 112)),
             seed 1 (chip_smoke.CANONICAL_TREE); the train CLI at the pancreas
             defaults + --max_iterations 20000 --save_every 1000
             --compute_dtype bfloat16 --fetch_ahead 1 --step_diagnostics
             cadence;
  brats19  - make_brats19(n_train=249, n_test=24, shape=(128, 128, 96)),
             seed 0; --max_iterations 20000 --save_every 500 --compute_dtype
             bfloat16.
Whatever follows `--` goes to the leg's CLI unchanged, after the driver's
own flags, so that it cuts or overrides the protocol: train flags for
fresh, resume, pack and unpack (pack and unpack read the run directory
from them), test flags for test (`-- --compute_dtype float32` runs a
leg for comparison with the bfloat16 run). `--n_train`, `--n_test` and
`--shape` cut the tree; `--device` is cuda unless the caller asks for cpu.
The smoke's phase canonical_relay, for example:
    ... --leg fresh --kill_at 45 -- --labelnum 4 --val_every 20 \
        --save_every 20 --max_iterations 80
    ... --leg test -- --labelnum 4 --max_iterations 80

Each train leg is a subprocess of the train CLI (`python -m
dycon_paper_replication_tpu_torch.cli.train_<dataset>`) with
`--time_budget_s`, whose clean, resumable exit is its one normal stop:
  fresh  - trains from scratch (the run directory must hold no checkpoint);
  resume - `--resume auto`: the latest `iter_<N>[_dice_<D>].pt`;
  test   - (pancreas) cli.test_pancreas on the best checkpoint, the dense
           protocol (patch 96^3, stride 16/4) in bfloat16, as the TPU run's;
  pack   - writes the files a later machine needs to go on (the latest
           checkpoint, the run's logs and the relay log) into `--carry`, a
           zip in which each tensor's bytes are split into planes (the
           teacher's XORed with the student's first) and deflated: lossless,
           about 0.8 of the checkpoint's size (57 MiB at the canonical
           width), so that a full train state fits through a copy of limited
           size; and the best model's student weights and metadata, all the
           test leg reads, into a second zip beside it, `<carry>_best.zip`
           (best_carry; 20 MiB). Where a copy back holds only one of the
           two, run the test leg before pack on a machine where the best
           changed: the relay log carries its line;
  unpack - restores `--carry` (and `<carry>_best.zip` where it exists) into
           the run directory, checking each tensor's SHA-256; the best model
           comes back as an evaluation checkpoint (student and metadata).
`--kill_at N` sends the leg SIGKILL (its whole process group) once its log
shows an iteration >= N: the crash that `--resume auto` recovers from.

Every leg appends one JSON line to `<work>/relay.jsonl`: the leg, its
return code, whether the driver killed it, its first and last iteration,
the checkpoint it resumed from with its step and the best-so-far it
carried, its wall seconds and ms per iteration and, on cuda, the card
(`nvidia-smi --query-gpu=name,power.limit`) and the most device memory in
use that nvidia-smi reported while it ran (sampled every 5 s). The driver
fails, and goes no further, on a leg that exits non-zero without being
killed, on a resume that starts anywhere but one past the last saved
iteration, and on a best-so-far that is not the one the run had logged by
that save. scripts/canonical_table_torch.py summarises the run beside the
TPU's record.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import signal
import subprocess
import math
import sys
import time
import zipfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from canonical_table_torch import parse_test_log  # noqa: E402
from chip_smoke import CANONICAL_TREE  # noqa: E402
from dycon_paper_replication_tpu_torch.config import config_from_args  # noqa: E402
from dycon_paper_replication_tpu_torch.data.synthetic import (  # noqa: E402
    make_brats19,
    make_pancreas,
)
from dycon_paper_replication_tpu_torch.utils import checkpoint  # noqa: E402

DATASETS = {
    "pancreas": dict(make=make_pancreas, tree=CANONICAL_TREE,
                     list_file="train.list", save_every=1000,
                     flags=["--fetch_ahead", "1", "--step_diagnostics", "cadence"]),
    "brats19": dict(make=make_brats19,
                    tree=dict(n_train=249, n_test=24, shape=(128, 128, 96), seed=0),
                    list_file="train.txt", save_every=500, flags=[]),
}
ITERATION = re.compile(r"Iteration (\d+) : ")
RESUMED = re.compile(r"Resumed full train state from (\S+) \(step (\d+), best-so-far ([0-9.]+)\)")
ITER_FILE = re.compile(r"iter_(\d+)(?:_dice_[0-9.]+)?\.pt")
TESTED = re.compile(r"init weight from (\S+)")
POLL_S, MEM_EVERY_S = 0.1, 5.0


class RelayError(RuntimeError):
    """A leg broke the relay's contract (module doc)."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", choices=sorted(DATASETS), default="pancreas")
    p.add_argument("--leg", choices=["fresh", "resume", "test", "pack", "unpack"],
                   required=True)
    p.add_argument("--root", type=str, default=None,
                   help="the data tree (default runs/canonical/<dataset>/data)")
    p.add_argument("--work", type=str, default=None,
                   help="runs, leg logs and relay.jsonl (default runs/canonical/<dataset>)")
    p.add_argument("--kill_at", type=int, default=0,
                   help="SIGKILL the leg once it logs an iteration >= N (0: never)")
    p.add_argument("--time_budget_s", type=float, default=3000.0)
    p.add_argument("--carry", type=str, default=None, help="the zip of --leg pack / unpack")
    p.add_argument("--n_train", type=int, default=None)
    p.add_argument("--n_test", type=int, default=None)
    p.add_argument("--shape", type=int, nargs=3, default=None)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The driver's flags, and in `cli` whatever follows `--` (module doc)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    args = build_parser().parse_args(argv[:cut])
    args.cli = argv[cut + 1:]
    return args


def paths(args) -> tuple[str, str]:
    work = args.work or os.path.join(ROOT, "runs", "canonical", args.dataset)
    return work, args.root or os.path.join(work, "data")


def train_argv(args) -> list[str]:
    """The train CLI's flags for this run, without the leg's own."""
    work, root = paths(args)
    spec = DATASETS[args.dataset]
    return ["--root_dir", root, "--snapshot_root", os.path.join(work, "runs"),
            "--max_iterations", "20000", "--save_every", str(spec["save_every"]),
            "--compute_dtype", "bfloat16", *spec["flags"], "--device", args.device, *args.cli]


def snapshot_path(args) -> str:
    return config_from_args(args.dataset, train_argv(args)).snapshot_path()


def ensure_tree(args) -> None:
    work, root = paths(args)
    spec = DATASETS[args.dataset]
    if os.path.exists(os.path.join(root, spec["list_file"])):
        return
    tree = dict(spec["tree"])
    for key in ("n_train", "n_test"):
        if getattr(args, key) is not None:
            tree[key] = getattr(args, key)
    if args.shape:
        tree["shape"] = tuple(args.shape)
    t0 = time.perf_counter()
    spec["make"](root, **tree, suffix=".npz")
    print(f"tree {root}: {tree} made in {time.perf_counter() - t0:.3f} s", flush=True)


def saved_iterations(snapshot: str) -> list[int]:
    names = os.listdir(snapshot) if os.path.isdir(snapshot) else []
    return sorted(int(m.group(1)) for m in map(ITER_FILE.fullmatch, names) if m)


def logged_best(snapshot: str, step: int) -> float:
    """The run's info/Best_dice as logged at its last validation at or
    before `step` (the last line wins: a resumed leg rewrites the steps
    after its checkpoint); 0.0 before the first validation."""
    best = 0.0
    path = os.path.join(snapshot, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                if row["tag"] == "info/Best_dice" and row["step"] <= step:
                    best = row["value"]
    return best


def _smi(query: str, fmt: str = "csv,noheader") -> str | None:
    """nvidia-smi --query-gpu=<query>'s answer, or None where it fails."""
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                              capture_output=True, text=True, check=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def card() -> str | None:
    return _smi("name,power.limit")


def device_mem_mib() -> float | None:
    """Device memory in use (nvidia-smi's memory.used, MiB), or None."""
    try:
        return float(_smi("memory.used", "csv,noheader,nounits").split()[0])
    except (AttributeError, ValueError, IndexError):
        return None


def run_leg(args, argv: list[str], log_path: str, kill_at: int = 0) -> dict:
    """Run `argv` as a subprocess with its output in `log_path`; SIGKILL it
    once its log shows an iteration >= kill_at (> 0). Returns the return
    code, whether it was killed, its iterations and resume line, its wall
    seconds and the most device memory seen in use."""
    on_cuda = args.device == "cuda"
    t0, t_mem, mem = time.time(), 0.0, None
    killed, last = False, None
    with open(log_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-u", *argv], stdout=out,
                                stderr=subprocess.STDOUT, cwd=ROOT, start_new_session=True)
        try:
            with open(log_path) as log:
                tail = ""  # a line not yet ended: read on with the next poll
                while proc.poll() is None:
                    time.sleep(POLL_S)
                    *lines, tail = (tail + log.read()).split("\n")
                    for m in filter(None, map(ITERATION.search, lines)):
                        last = int(m.group(1))
                    if on_cuda and time.time() - t_mem >= MEM_EVERY_S:
                        t_mem, used = time.time(), device_mem_mib()
                        if used is not None:
                            mem = max(mem or 0.0, used)
                    if kill_at and last is not None and last >= kill_at and not killed:
                        os.killpg(proc.pid, signal.SIGKILL)
                        killed = True
                        print(f"leg reached iteration {last}: SIGKILL {proc.pid} (deliberate)",
                              flush=True)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
            rc = proc.wait()
    with open(log_path) as log:
        text = log.read()
    iters = [int(m.group(1)) for m in ITERATION.finditer(text)]
    resumed = RESUMED.search(text)
    return dict(rc=rc, killed=killed, first_iter=iters[0] if iters else None,
                last_iter=iters[-1] if iters else None,
                resumed_from=resumed and os.path.basename(resumed.group(1)),
                resumed_step=resumed and int(resumed.group(2)),
                best_carried=resumed and float(resumed.group(3)),
                t_start=t0, t_end=time.time(), wall_s=time.time() - t0, device_mem_mib=mem)


def record(args, line: dict) -> None:
    work, _ = paths(args)
    with open(os.path.join(work, "relay.jsonl"), "a") as f:
        f.write(json.dumps(line) + "\n")
    print("relay " + json.dumps(line), flush=True)


def leg_index(work: str) -> int:
    path = os.path.join(work, "relay.jsonl")
    if not os.path.exists(path):
        return 1
    with open(path) as f:
        return 1 + sum(1 for line in f if line.strip())


def train_leg(args) -> dict:
    """Leg fresh or resume (module doc); raises RelayError on a broken contract."""
    work, _ = paths(args)
    ensure_tree(args)
    snapshot = snapshot_path(args)
    saved = saved_iterations(snapshot)
    if args.leg == "fresh" and saved:
        raise RelayError(f"leg fresh: {snapshot} already holds checkpoints {saved[-3:]}")
    if args.leg == "resume" and not saved:
        raise RelayError(f"leg resume: no checkpoint in {snapshot}")
    last_save = saved[-1] if saved else 0
    want_best = logged_best(snapshot, last_save)
    n = leg_index(work)
    os.makedirs(os.path.join(work, "logs"), exist_ok=True)
    argv = ["-m", f"dycon_paper_replication_tpu_torch.cli.train_{args.dataset}",
            *train_argv(args), "--time_budget_s", str(args.time_budget_s),
            *(["--resume", "auto"] if args.leg == "resume" else [])]
    print(f"leg {n} ({args.leg}): {' '.join(argv)}", flush=True)
    out = run_leg(args, argv, os.path.join(work, "logs", f"leg{n}_{args.leg}.log"), args.kill_at)
    iters = (out["last_iter"] or 0) - (out["first_iter"] or 1) + 1
    line = dict(leg=n, kind=args.leg, dataset=args.dataset, kill_at=args.kill_at,
                time_budget_s=args.time_budget_s, last_save_before=last_save,
                best_before=want_best, saved_after=saved_iterations(snapshot)[-1:],
                ms_per_iter=1e3 * out["wall_s"] / iters if iters > 0 else None,
                card=card() if args.device == "cuda" else None, **out)
    record(args, line)
    faults = []
    if out["rc"] != 0 and not out["killed"]:
        faults.append(f"exited {out['rc']} without being killed")
    if args.kill_at and not out["killed"]:
        faults.append(f"was to be killed at {args.kill_at} but ended at {out['last_iter']}")
    if args.leg == "fresh" and out["first_iter"] != 1:
        faults.append(f"fresh leg started at iteration {out['first_iter']}")
    if args.leg == "resume":
        if out["resumed_step"] != last_save or out["first_iter"] != last_save + 1:
            faults.append(f"resumed at step {out['resumed_step']}, first iteration "
                          f"{out['first_iter']}; the last save was {last_save}")
        if out["best_carried"] is None or abs(out["best_carried"] - want_best) > 5e-5:
            faults.append(f"carried best-so-far {out['best_carried']}, the run had logged "
                          f"{want_best} by iteration {last_save}")
    if faults:
        raise RelayError(f"leg {n} ({args.leg}): " + "; ".join(faults))
    return line


def test_leg(args) -> dict:
    """Leg test (module doc): the test CLI on the best checkpoint of the run
    directory that its flags name; raises RelayError where it fails."""
    if args.dataset != "pancreas":
        raise SystemExit("--leg test runs the Pancreas test CLI; the BraTS relay has none")
    work, root = paths(args)
    ensure_tree(args)
    argv = ["-m", "dycon_paper_replication_tpu_torch.cli.test_pancreas", "--root_path", root,
            "--snapshot_root", os.path.join(work, "runs"), "--max_iterations", "20000",
            "--compute_dtype", "bfloat16", "--device", args.device, *args.cli]
    n = leg_index(work)
    os.makedirs(os.path.join(work, "logs"), exist_ok=True)
    log = os.path.join(work, "logs", f"leg{n}_test.log")
    print(f"leg {n} (test): {' '.join(argv)}", flush=True)
    out = run_leg(args, argv, log)
    with open(log) as f:
        text = f.read()
    scores, tested = parse_test_log(text), TESTED.search(text)
    meta = tested and torch.load(tested.group(1), map_location="cpu", weights_only=True)["meta"]
    line = dict(leg=n, kind="test", dataset=args.dataset, rc=out["rc"],
                tested=tested and os.path.basename(tested.group(1)),
                best_step=meta and meta.get("step"), best_dice=meta and meta.get("best_dice"),
                logged_best=tested and logged_best(os.path.dirname(tested.group(1)), math.inf),
                wall_s=out["wall_s"], t_start=out["t_start"], t_end=out["t_end"],
                device_mem_mib=out["device_mem_mib"],
                card=card() if args.device == "cuda" else None, **scores)
    record(args, line)
    if out["rc"] != 0 or scores["mean"] is None:
        last = text.strip().splitlines()[-1:] or [""]
        raise RelayError(f"leg {n} (test): exited {out['rc']}, averages {scores['mean']}: "
                         f"{last[0]} ({log})")
    return line


def _planes(t: torch.Tensor) -> bytes:
    a = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(a.reshape(-1, t.element_size()).T).tobytes()


def _unplanes(data: bytes, dtype: str, shape: list[int]) -> torch.Tensor:
    dt = getattr(torch, dtype.removeprefix("torch."))
    size = torch.empty((), dtype=dt).element_size()
    a = np.frombuffer(data, np.uint8).reshape(size, -1).T.copy()
    return torch.from_numpy(a.reshape(-1)).view(dt).reshape(shape)


def _xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int32) ^ b.view(torch.int32)).view(torch.float32)


def _sha(t: torch.Tensor) -> str:
    data = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(data).hexdigest()


def best_carry(carry: str) -> str:
    """The zip beside `carry` that holds the best model (module doc)."""
    return os.path.splitext(carry)[0] + "_best.zip"


def _write_tensors(z: zipfile.ZipFile, prefix: str, sd: dict, ref: dict | None = None) -> dict:
    """Each tensor of `sd` as byte planes under `prefix`, XORed with its
    float32 namesake in `ref` first where there is one; their manifest."""
    specs = {}
    for key, t in sd.items():
        r = ref.get(key) if ref is not None else None
        xor = r is not None and t.dtype == r.dtype == torch.float32 and t.shape == r.shape
        specs[key] = dict(dtype=str(t.dtype), shape=list(t.shape), xor=xor, sha256=_sha(t))
        z.writestr(f"{prefix}/{key}", _planes(_xor(t, r) if xor else t))
    return specs


def _read_tensors(z: zipfile.ZipFile, prefix: str, specs: dict, ref: dict | None = None) -> dict:
    """The inverse of _write_tensors, each tensor checked against its SHA-256."""
    out = {}
    for key, spec in specs.items():
        t = _unplanes(z.read(f"{prefix}/{key}"), spec["dtype"], spec["shape"])
        if spec["xor"]:
            t = _xor(t, ref[key])
        if _sha(t) != spec["sha256"]:
            raise RelayError(f"unpack: {prefix}/{key} does not match its SHA-256")
        out[key] = t
    return out


def pack(args) -> dict:
    """--leg pack (module doc): the latest checkpoint, metrics.jsonl,
    log.txt, config.json, relay.jsonl and the leg logs into --carry; the
    best model's student and metadata into best_carry(--carry)."""
    work, _ = paths(args)
    snapshot = snapshot_path(args)
    saved = saved_iterations(snapshot)
    if not saved:
        raise RelayError(f"leg pack: no checkpoint in {snapshot}")
    name = next(n for n in os.listdir(snapshot)
                if (m := ITER_FILE.fullmatch(n)) and int(m.group(1)) == saved[-1])
    ckpt = torch.load(os.path.join(snapshot, name), map_location="cpu", weights_only=True)
    manifest = dict(file=name, step=ckpt["step"], meta=ckpt["meta"], tensors={})
    os.makedirs(os.path.dirname(os.path.abspath(args.carry)), exist_ok=True)
    with zipfile.ZipFile(args.carry, "w", zipfile.ZIP_DEFLATED, compresslevel=6) as z:
        # the teacher is an EMA of the student: XORed, its high bytes are mostly 0
        for part in ("model", "teacher", "momentum"):
            manifest["tensors"][part] = _write_tensors(
                z, f"ckpt/{part}", ckpt[part], ckpt["model"] if part == "teacher" else None)
        logs = os.path.join(work, "logs")
        files = [(os.path.join(snapshot, f), f"run/{f}")
                 for f in ("metrics.jsonl", "log.txt", "config.json")]
        names = sorted(os.listdir(logs)) if os.path.isdir(logs) else []
        files += [(os.path.join(work, f), f"work/{f}")
                  for f in ["relay.jsonl"] + [f"logs/{n}" for n in names]]
        for path, arcname in files:
            if os.path.exists(path):
                z.write(path, arcname)
        z.writestr("manifest.json", json.dumps(manifest))
    out = dict(file=name, step=ckpt["step"], mib=os.path.getsize(args.carry) / 2 ** 20)
    best_path = checkpoint.best_checkpoint_path(snapshot, config_from_args(
        args.dataset, train_argv(args)).model)
    if os.path.isfile(best_path):
        best = torch.load(best_path, map_location="cpu", weights_only=True)
        with zipfile.ZipFile(best_carry(args.carry), "w", zipfile.ZIP_DEFLATED,
                             compresslevel=6) as z:
            specs = _write_tensors(z, "best/model", best["model"])
            z.writestr("manifest.json", json.dumps(dict(
                file=os.path.basename(best_path), meta=best["meta"], tensors=specs)))
        out.update(best_step=best["meta"].get("step"),
                   best_mib=os.path.getsize(best_carry(args.carry)) / 2 ** 20)
    elif os.path.exists(best_carry(args.carry)):
        os.remove(best_carry(args.carry))  # an older run's: it is not this run's best
    print(f"packed {name} (step {ckpt['step']}) and the logs into {args.carry}: "
          f"{out['mib']:.3f} MiB; best model {out.get('best_step')}: "
          f"{out.get('best_mib', 0.0):.3f} MiB", flush=True)
    return out


def unpack(args) -> dict:
    """--leg unpack (module doc): the inverse of pack, each tensor checked."""
    work, _ = paths(args)
    snapshot = snapshot_path(args)
    if saved_iterations(snapshot):
        raise RelayError(f"leg unpack: {snapshot} already holds checkpoints")
    os.makedirs(snapshot, exist_ok=True)
    with zipfile.ZipFile(args.carry) as z:
        manifest = json.loads(z.read("manifest.json"))
        ckpt = {"step": manifest["step"], "meta": manifest["meta"]}
        for part in ("model", "teacher", "momentum"):  # model first: the teacher XORs with it
            ckpt[part] = _read_tensors(z, f"ckpt/{part}", manifest["tensors"][part],
                                       ckpt["model"] if part == "teacher" else None)
        for member in z.namelist():
            if member.startswith(("run/", "work/")):
                base = snapshot if member.startswith("run/") else work
                dst = os.path.join(base, member.split("/", 1)[1])
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                with open(dst, "wb") as f:
                    f.write(z.read(member))
    torch.save(ckpt, os.path.join(snapshot, manifest["file"]))
    out = dict(file=manifest["file"], step=manifest["step"])
    if os.path.exists(best_carry(args.carry)):
        with zipfile.ZipFile(best_carry(args.carry)) as z:
            best = json.loads(z.read("manifest.json"))
            model = _read_tensors(z, "best/model", best["tensors"])
        torch.save({"model": model, "meta": best["meta"]}, os.path.join(snapshot, best["file"]))
        out.update(best_step=best["meta"].get("step"))
    print(f"unpacked {manifest['file']} (step {manifest['step']}) and best model "
          f"{out.get('best_step')} into {snapshot}", flush=True)
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.leg in ("pack", "unpack") and not args.carry:
        raise SystemExit(f"--leg {args.leg} needs --carry")
    work, _ = paths(args)
    os.makedirs(work, exist_ok=True)
    leg = {"fresh": train_leg, "resume": train_leg, "test": test_leg, "pack": pack,
           "unpack": unpack}[args.leg]
    return leg(args)


if __name__ == "__main__":
    try:
        main()
    except RelayError as e:
        print(f"canonical_run_torch: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
