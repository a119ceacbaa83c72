#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package into the port's checkpoint of the
same role.

    python scripts/convert_jax_checkpoint.py SOURCE [--member NAME]
        [--dataset pancreas|brats19|isles22] [the train CLI's flags]
        [--out FILE]

SOURCE is an orbax checkpoint directory written by the JAX package
(dycon_paper_replication_tpu/utils/checkpoint.py:save_checkpoint), or a
`.tar.gz` archive with `--member` naming the directory inside it, which is
read straight out of the archive. The restore template is built as the JAX
test CLI builds it (`create_train_state(model, jax.random.key(0),
make_optimizer(lambda s: 0.0))`) from `--model`, `--in_ch`,
`--num_classes`, `--feature_scaler` and `--use_aspp`.

The directory's name gives the role:
  * `<model>_best_model` becomes the port's best-model checkpoint (the
    student's state_dict, utils/checkpoint.py:save_checkpoint), read by the
    test CLIs;
  * `iter_<N>[_dice_<D>]` becomes the port's full train state (student,
    teacher, momentum and step, utils/checkpoint.py:save_train_state), read
    by the train CLIs' `--resume`.
It is written at the port's path for the same flags, under the run
directory `TrainConfig.snapshot_path()` (`--snapshot_root`, `--exp`,
`--labelnum`, `--max_iterations`, ...), or at `--out`. Float32 leaves are
carried bit for bit (weights.py). The metadata records the source, the
member, the checkpoint's step and the best dice of its `graft_meta.json`.

Needs JAX and orbax; runs on the CPU. The port itself reads the result
with torch alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import tarfile
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_ITER = re.compile(r"iter_(\d+)(?:_dice_([0-9.]+))?")


def build_parser(dataset: str) -> argparse.ArgumentParser:
    from dycon_paper_replication_tpu_torch import config

    p = config.build_parser(dataset)
    p.description = "Convert a JAX (orbax) checkpoint into the port's"
    p.add_argument("source", help="an orbax checkpoint directory, or a .tar.gz holding one")
    p.add_argument("--member", default="",
                   help="the checkpoint directory inside the .tar.gz SOURCE")
    p.add_argument("--dataset", default=dataset, choices=sorted(config.DATASET_DEFAULTS))
    p.add_argument("--out", default="",
                   help="write here instead of the run directory of the flags")
    return p


def extract(archive: str, member: str, into: str) -> str:
    """Unpack the directory `member` of `archive` under `into`; its path."""
    with tarfile.open(archive) as tar:
        names = [m for m in tar.getmembers()
                 if m.name == member or m.name.startswith(member.rstrip("/") + "/")]
        if not names:
            raise FileNotFoundError(f"{archive} holds no member {member!r}")
        tar.extractall(into, members=names, filter="data")
    return os.path.join(into, member)


def restore_jax(path: str, cfg):
    """The JAX TrainState at the orbax directory `path`, numpy leaves."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from dycon_paper_replication_tpu.models import net_factory_3d
    from dycon_paper_replication_tpu.train.state import create_train_state, make_optimizer
    from dycon_paper_replication_tpu.utils import checkpoint

    model = net_factory_3d(cfg.model, in_chns=cfg.in_ch, class_num=cfg.num_classes,
                           scaler=cfg.feature_scaler, use_aspp=cfg.use_aspp)
    template = create_train_state(model, jax.random.key(0), make_optimizer(lambda s: 0.0))
    return jax.tree.map(np.asarray, checkpoint.restore_checkpoint(path, template))


def save_port(js, name: str, cfg, out: str = "", meta: dict | None = None) -> str:
    """Write the JAX TrainState `js` (numpy leaves) of the orbax directory
    named `name` as the port's checkpoint of the same role for the port's
    config `cfg`, at `out` or the run directory's path; returns the path."""
    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.models.factory import build_model, model_config
    from dycon_paper_replication_tpu_torch.utils import checkpoint

    meta = dict(meta or {}, step=int(js.step))
    net_cfg = model_config(cfg.model, in_chns=cfg.in_ch, class_num=cfg.num_classes,
                           scaler=cfg.feature_scaler, use_aspp=cfg.use_aspp)
    snapshot = cfg.snapshot_path()
    if name.endswith("_best_model"):
        net = build_model(net_cfg)
        net.load_state_dict(weights.jax_tree_to_state_dict(js.params, js.model_state))
        out = out or checkpoint.best_checkpoint_path(snapshot, cfg.model)
        checkpoint.save_checkpoint(out, net, meta)
        return out
    m = _ITER.fullmatch(name)
    if m is None:
        raise ValueError(f"{name!r} is neither <model>_best_model nor iter_<N>[_dice_<D>]")
    dice = float(m.group(2)) if m.group(2) else None
    out = out or checkpoint.iter_checkpoint_path(snapshot, int(m.group(1)), dice)
    checkpoint.save_train_state(out, weights.jax_train_state_to_torch(js, net_cfg), meta)
    return out


def convert(path: str, cfg, out: str = "", source: str = "", member: str = "") -> str:
    """Convert the orbax directory `path` (which is `member` of the archive
    `source`, or the directory `source` itself) for the port's config
    `cfg`; returns the path written."""
    meta = {"source": source or path, "member": member}
    try:
        with open(os.path.join(path, "graft_meta.json")) as f:
            meta["best_dice"] = float(json.load(f)["best_dice"])
    except (OSError, KeyError, ValueError):
        pass
    name = os.path.basename(os.path.normpath(member or path))
    return save_port(restore_jax(path, cfg), name, cfg, out, meta)


def main(argv=None) -> str:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--dataset", default="pancreas")
    dataset = pre.parse_known_args(argv)[0].dataset
    args = build_parser(dataset).parse_args(argv)

    from dycon_paper_replication_tpu_torch.config import TrainConfig, make_config

    # the train CLI's config_from_args, on the flags that this parser shares with it
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in vars(args).items() if k in fields and k != "dataset"}
    kw.update(patch_size=tuple(args.patch_size), use_aspp=bool(args.use_aspp))
    cfg = make_config(dataset, **kw)
    if args.member:
        with tempfile.TemporaryDirectory() as tmp:
            out = convert(extract(args.source, args.member, tmp), cfg, args.out,
                          args.source, args.member)
    else:
        out = convert(args.source, cfg, args.out, args.source)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
