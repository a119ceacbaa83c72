#!/usr/bin/env python3
"""Summarise the port's canonical relay run (scripts/canonical_run_torch.py)
beside the TPU's committed record of the same run, and hold it to the gates.

    python3 scripts/canonical_table_torch.py --dataset pancreas \
        [--work runs/canonical/pancreas] [--reach N] [--compare WORK2] [--out table.json]

Reads the run's metrics.jsonl (under `--work`/runs), the relay log
(`--work`/relay.jsonl), the leg logs (`--work`/logs) and the test leg's
scores, and prints, beside the TPU's `bench_results/r05_canonical20k_*`
(Pancreas) or `r05_brats_endurance_metrics.jsonl` (BraTS):
  * scripts/summarize_canon20k.py's rows, computed as it computes them:
    the iterations reached, the validations (every row, a resumed leg's
    repeats too), best val Dice, val Dice at the milestones, host RSS min /
    median / max, the legs (from -> to) and the dense test's Dice /
    Jaccard / HD95 / ASD;
  * info/loss window means (the 201 iterations centred on the milestone,
    ending at the last iteration where they would run past it; a step
    logged twice counts its last row) at 1000, 5000, 10000 and 20000;
  * the step scalars against the TPU's at the same steps (info/loss,
    loss_ce, loss_dice, f_loss, u_loss, consistency_loss): |port / TPU - 1|
    in windows of steps (1, 2-10, 11-100, 101-1000, 1001-2000; a step
    logged twice counts its last row), the median and max of each; since
    the port draws the TPU run's initial weights, noise and dropout masks
    from the same seed (ops/threefry.py), these start at bf16's rounding
    and show how fast the two trajectories part;
  * with `--compare` (a second run's work directory or metrics.jsonl, e.g.
    a float32 or another seed's leg): its iterations, best val Dice,
    milestones, loss windows and step windows beside the first run's;
  * the NaN/Inf-skipped steps (the leg logs' lines), ms per iteration of
    the loop (the median gap between consecutive info/loss rows of a leg)
    and wall ms per iteration, and the device memory in use per leg
    (nvidia-smi, the driver's samples), with the card's name and power
    limit.
No TPU time or rate is printed: only its Dice, loss and host RSS.

Gates (the Pancreas relay; BraTS holds (a) and its milestones):
  (a) the run reaches `--reach` (20000; BraTS 3400); every leg exits 0 but the one the driver
      killed; each resume starts one past the last save and carries the
      best-so-far logged by then (the driver checks both and records them);
  (b) best val Dice within BEST_TOL of the TPU's;
  (c) val Dice at each milestone within MILESTONE_TOL of the TPU's row;
  (d) the relay log's last test ran on the run's best model (its best
      Dice the last info/Best_dice logged); its mean Dice within
      DICE_MEAN_TOL of the TPU's, Jaccard within JACCARD_TOL, every
      volume's Dice within DICE_VOLUME_TOL of its row of the TPU's log
      (chip_smoke.TPU_LOG, the bounds of its phase trained_eval);
  (e) no leak: in each leg of >= LEAK_MIN_ITERS iterations, host RSS at its
      last validation within RSS_GROWTH x its value 1000 iterations into
      the leg; each leg's device memory within DEVICE_MEM_TOL of leg 1's.
Pure host code: reads files, imports no torch.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import DICE_MEAN_TOL, DICE_VOLUME_TOL, TPU_LOG  # noqa: E402

RECORD = {
    "pancreas": dict(metrics="bench_results/r05_canonical20k_metrics.jsonl",
                     test="bench_results/r05_canonical20k_test_eval.log",
                     milestones=(1000, 2000, 5000, 10000, 15000, 20000),
                     loss_windows=(1000, 5000, 10000, 20000), reach=20000),
    "brats19": dict(metrics="bench_results/r05_brats_endurance_metrics.jsonl", test=None,
                    milestones=(1000, 2000, 3000, 3400), loss_windows=(1000, 2000, 3000),
                    reach=3400),
}
BEST_TOL, MILESTONE_TOL, JACCARD_TOL = 0.001, 0.002, 0.002
RSS_GROWTH, LEAK_MIN_ITERS, DEVICE_MEM_TOL = 1.5, 5000, 0.02
WINDOW = 201
STEP_SCALARS = ("loss", "loss_ce", "loss_dice", "f_loss", "u_loss", "consistency_loss")
STEP_WINDOWS = ((1, 1), (2, 10), (11, 100), (101, 1000), (1001, 2000))
SKIPPED = re.compile(r"NaN or Inf found in loss at iteration")
CASE = re.compile(r"^(\d+)\s+\|\s+([0-9.]+)\s+\|\s+([0-9.]+)\s+\|\s+([0-9.]+)\s+\|\s+([0-9.]+)",
                  re.M)
FINAL = re.compile(r"FINAL AVERAGE METRICS:\s*\n.*\n\s*([0-9.]+)\s+([0-9.]+)\s+([0-9.]+)\s+"
                   r"([0-9.]+)")


def load_rows(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def by_tag(rows: list[dict]) -> dict[str, list[tuple[int, float]]]:
    out: dict[str, list[tuple[int, float]]] = {}
    for r in rows:
        out.setdefault(r["tag"], []).append((r["step"], r["value"]))
    return out


def summarize(rows: list[dict], milestones=RECORD["pancreas"]["milestones"]) -> dict:
    """summarize_canon20k.py's rows of one metrics.jsonl, computed as it does."""
    tags = by_tag(rows)
    max_step = max(s for s, _ in tags["info/loss"])
    val = sorted(tags.get("info/Dice", []))
    curve = {s: v for s, v in val}
    rss = [v for _, v in tags.get("perf/host_rss_gb", [])]
    return dict(
        max_step=max_step, validations=len(val),
        best=max((v for _, v in val), default=float("nan")),
        milestones={m: curve[max(k for k in curve if k <= m)]
                    for m in milestones if m <= max_step and any(k <= m for k in curve)},
        rss=[min(rss), statistics.median(rss), max(rss)] if rss else None)


def loss_windows(rows: list[dict], centres) -> dict:
    """info/loss means over the WINDOW iterations centred on each centre
    (shifted to end at the last iteration); a repeated step's last row."""
    loss = {s: v for s, v in by_tag(rows)["info/loss"]}
    last = max(loss)
    out = {}
    for c in centres:
        hi = min(c + WINDOW // 2, last)
        vals = [loss[s] for s in range(hi - WINDOW + 1, hi + 1) if s in loss]
        if c <= last and vals:
            out[c] = sum(vals) / len(vals)
    return out


def step_differences(rows: list[dict], ref_rows: list[dict], windows=STEP_WINDOWS) -> dict:
    """|run / ref - 1| of each of STEP_SCALARS at the steps both logged, by
    window of steps (a step logged twice counts its last row): {scalar:
    {"lo-hi": {"n", "median", "max"}}}."""
    run, ref = by_tag(rows), by_tag(ref_rows)
    out: dict = {}
    for name in STEP_SCALARS:
        a, b = dict(run.get(f"info/{name}", [])), dict(ref.get(f"info/{name}", []))
        for lo, hi in windows:
            rel = [abs(a[s] / b[s] - 1) for s in range(lo, hi + 1) if s in a and s in b and b[s]]
            if rel:
                out.setdefault(name, {})[f"{lo}-{hi}"] = dict(
                    n=len(rel), median=statistics.median(rel), max=max(rel))
    return out


def metrics_path(path: str) -> str:
    """A metrics.jsonl given, or the one under a work directory's runs/."""
    if path.endswith(".jsonl"):
        return path
    found = next(iter(glob.glob(os.path.join(path, "runs", "*", "*", "metrics.jsonl"))), None)
    if found is None:
        raise SystemExit(f"no metrics.jsonl under {path}/runs")
    return found


def parse_test_log(text: str) -> dict:
    """The test CLI's per-volume rows and averages (Dice, Jaccard, HD95, ASD)."""
    final = FINAL.search(text)
    return dict(cases=[[float(v) for v in m.groups()[1:]] for m in CASE.finditer(text)],
                mean=[float(v) for v in final.groups()] if final else None)


def leg_rows(relay: list[dict], rows: list[dict], work: str) -> list[dict]:
    """Per train leg: from -> to, its rc, ms per iteration of the loop, RSS
    1000 iterations in and at its last validation, device memory, skips."""
    out = []
    for leg in (r for r in relay if r["kind"] in ("fresh", "resume")):
        inside = [r for r in rows if leg["t_start"] <= r["t"] <= leg["t_end"]]
        t_loss = [r["t"] for r in inside if r["tag"] == "info/loss"]
        gaps = [b - a for a, b in zip(t_loss, t_loss[1:])]
        rss = sorted((r["step"], r["value"]) for r in inside if r["tag"] == "perf/host_rss_gb")
        first = leg["first_iter"] or 0
        at_1000 = next((v for s, v in rss if s >= first - 1 + 1000), None)
        log = os.path.join(work, "logs", f"leg{leg['leg']}_{leg['kind']}.log")
        skips = None
        if os.path.exists(log):
            with open(log) as f:
                skips = len(SKIPPED.findall(f.read()))
        out.append(dict(leg=leg["leg"], kind=leg["kind"], rc=leg["rc"], killed=leg["killed"],
                        first=leg["first_iter"], last=leg["last_iter"],
                        resumed_from=leg["resumed_from"], best_carried=leg["best_carried"],
                        ms_per_iter_loop=1e3 * statistics.median(gaps) if gaps else None,
                        ms_per_iter_wall=leg["ms_per_iter"], device_mem_mib=leg["device_mem_mib"],
                        rss_1000_in=at_1000, rss_last_val=rss[-1][1] if rss else None,
                        skips=skips, card=leg.get("card")))
    return out


def gates(dataset: str, run: dict, tpu: dict, legs: list[dict], test: dict | None,
          tpu_test: dict | None, reach: int) -> dict:
    """Each gate: (met, what it compared)."""
    g = {}
    faults = [f"leg {l['leg']} rc {l['rc']}" for l in legs if l["rc"] != 0 and not l["killed"]]
    g["a"] = (run["max_step"] >= reach and not faults and bool(legs),
              f"reached {run['max_step']} of {reach}; {faults or 'every leg 0 or killed'}")
    if dataset == "pancreas":
        g["b"] = (abs(run["best"] - tpu["best"]) <= BEST_TOL,
                  f"best {run['best']:.5f} against {tpu['best']:.5f} (tol {BEST_TOL})")
    miss = {m: (run["milestones"].get(m), v) for m, v in tpu["milestones"].items()
            if run["milestones"].get(m) is None or abs(run["milestones"][m] - v) > MILESTONE_TOL}
    g["c"] = (not miss, f"milestones off by more than {MILESTONE_TOL}: {miss or 'none'}")
    if dataset != "pancreas":
        return g
    if test and test["mean"] and tpu_test and tpu_test["mean"]:
        n = len(test["cases"])
        bad = [i for i in range(n) if abs(test["cases"][i][0] - TPU_LOG[i][0]) > DICE_VOLUME_TOL]
        g["d"] = (n == len(TPU_LOG) and not bad and test["best_dice"] == run["final_best"]
                  and abs(test["mean"][0] - tpu_test["mean"][0]) <= DICE_MEAN_TOL
                  and abs(test["mean"][1] - tpu_test["mean"][1]) <= JACCARD_TOL,
                  f"tested the best of {test['best_step']} ({test['best_dice']}; the run's "
                  f"{run['final_best']}); Dice {test['mean'][0]} / {tpu_test['mean'][0]}, "
                  f"Jaccard {test['mean'][1]} / {tpu_test['mean'][1]}, {n} volumes, off by > "
                  f"{DICE_VOLUME_TOL}: {bad}")
    else:
        g["d"] = (False, "no dense test")
    leaks = []
    mem0 = legs[0]["device_mem_mib"] if legs else None
    for l in legs:
        n_iter = (l["last"] or 0) - (l["first"] or 0) + 1
        if n_iter >= LEAK_MIN_ITERS and l["rss_1000_in"] and l["rss_last_val"] \
                and l["rss_last_val"] > RSS_GROWTH * l["rss_1000_in"]:
            leaks.append(f"leg {l['leg']} RSS {l['rss_1000_in']} -> {l['rss_last_val']}")
        if mem0 and l["device_mem_mib"] and abs(l["device_mem_mib"] - mem0) > DEVICE_MEM_TOL * mem0:
            leaks.append(f"leg {l['leg']} device {l['device_mem_mib']} MiB against {mem0}")
        if mem0 is None or l["device_mem_mib"] is None:
            leaks.append(f"leg {l['leg']}: no device memory sample")
    g["e"] = (not leaks, "; ".join(leaks) or "RSS and device memory flat")
    return g


def table(args) -> dict:
    spec = RECORD[args.dataset]
    work = args.work or os.path.join(ROOT, "runs", "canonical", args.dataset)
    metrics = metrics_path(work)
    rows = load_rows(metrics)
    tpu_rows = load_rows(os.path.join(ROOT, spec["metrics"]))
    run, tpu = (summarize(r, spec["milestones"]) for r in (rows, tpu_rows))
    run["final_best"] = ([v for _, v in by_tag(rows).get("info/Best_dice", [])] or [None])[-1]
    out = dict(dataset=args.dataset, metrics=metrics, port=run, tpu=tpu,
               loss_windows=dict(port=loss_windows(rows, spec["loss_windows"]),
                                 tpu=loss_windows(tpu_rows, spec["loss_windows"])),
               steps=step_differences(rows, tpu_rows))
    if args.compare:
        second = load_rows(metrics_path(args.compare))
        out["second"] = dict(metrics=metrics_path(args.compare),
                             port=summarize(second, spec["milestones"]),
                             loss_windows=loss_windows(second, spec["loss_windows"]),
                             steps=step_differences(second, tpu_rows))
    relay_path = os.path.join(work, "relay.jsonl")
    relay = load_rows(relay_path) if os.path.exists(relay_path) else []
    legs = leg_rows(relay, rows, work)
    test = next((r for r in reversed(relay) if r["kind"] == "test"), None)
    tpu_test = None
    if spec["test"]:
        with open(os.path.join(ROOT, spec["test"])) as f:
            tpu_test = parse_test_log(f.read())
    out.update(legs=legs, skips=sum(l["skips"] or 0 for l in legs),
               test=test and dict(mean=test["mean"], cases=test["cases"],
                                  best_step=test["best_step"], best_dice=test["best_dice"]),
               tpu_test=tpu_test and dict(mean=tpu_test["mean"]),
               card=next((l["card"] for l in legs if l.get("card")), None))
    out["gates"] = {k: dict(met=v[0], detail=v[1]) for k, v in
                    gates(args.dataset, run, tpu, legs, out["test"], tpu_test,
                          args.reach or spec["reach"]).items()}
    return out


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.4f}"


def show(out: dict) -> None:
    run, tpu = out["port"], out["tpu"]
    second = out.get("second")
    two = second["port"] if second else None
    extra = (lambda v: f" {v:>22}") if second else (lambda v: "")
    print(f"{'':32} {'port':>22} {'TPU (r05)':>22}" + extra("second run"))
    print(f"{'max training iteration reached':32} {run['max_step']:>22} {tpu['max_step']:>22}"
          + extra(two and two["max_step"]))
    print(f"{'validations':32} {run['validations']:>22} {tpu['validations']:>22}"
          + extra(two and two["validations"]))
    print(f"{'best val Dice':32} {run['best']:>22.5f} {tpu['best']:>22.5f}"
          + extra(two and f"{two['best']:.5f}"))
    for m in sorted(set(run["milestones"]) | set(tpu["milestones"])):
        print(f"{f'val Dice at {m}':32} {_fmt(run['milestones'].get(m)):>22} "
              f"{_fmt(tpu['milestones'].get(m)):>22}"
              + extra(two and _fmt(two["milestones"].get(m))))
    windows = out["loss_windows"]
    for c in sorted(set(windows["tpu"]) | set(windows["port"])):
        print(f"{f'info/loss {WINDOW}-window at {c}':32} {_fmt(windows['port'].get(c)):>22} "
              f"{_fmt(windows['tpu'].get(c)):>22}"
              + extra(second and _fmt(second["loss_windows"].get(c))))
    for label, steps in (("port", out["steps"]), ("second run", second and second["steps"])):
        for name, by_window in (steps or {}).items():
            cells = ", ".join(f"{w}: {d['median']:.2e} / {d['max']:.2e}"
                              for w, d in by_window.items())
            print(f"|{label} / TPU - 1| {name} (median / max by steps): {cells}")
    for name, r in (("port", run), ("TPU", tpu)):
        if r["rss"]:
            print(f"host RSS GB min/median/max {name}: {r['rss'][0]:.3f} / {r['rss'][1]:.3f} / "
                  f"{r['rss'][2]:.3f}")
    print(f"card: {out['card']}; NaN/Inf-skipped steps: {out['skips']}")
    for l in out["legs"]:
        print(f"  leg {l['leg']} {l['kind']} rc={l['rc']}{' (killed)' if l['killed'] else ''}: "
              f"{l['first']} -> {l['last']}, resumed from {l['resumed_from']} best "
              f"{l['best_carried']}; ms/iter loop {l['ms_per_iter_loop']}, wall "
              f"{l['ms_per_iter_wall']}; device MiB {l['device_mem_mib']}; RSS GB 1000 in "
              f"{l['rss_1000_in']}, last val {l['rss_last_val']}")
    if out.get("test"):
        t, tt = out["test"], out["tpu_test"]
        print(f"dense test (best at {t['best_step']}, {t['best_dice']}): Dice / Jaccard / HD95 / "
              f"ASD {t['mean']} against the TPU's {tt and tt['mean']}")
    for k, g in out["gates"].items():
        print(f"gate ({k}) {'met' if g['met'] else 'NOT MET'}: {g['detail']}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", choices=sorted(RECORD), default="pancreas")
    p.add_argument("--work", type=str, default=None)
    p.add_argument("--reach", type=int, default=None,
                   help="the iteration gate (a) asks for (20000 Pancreas, 3400 BraTS)")
    p.add_argument("--compare", type=str, default=None,
                   help="a second run's work directory or metrics.jsonl, shown beside the first")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    out = table(args)
    show(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    return out


if __name__ == "__main__":
    main()
