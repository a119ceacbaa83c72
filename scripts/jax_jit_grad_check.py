#!/usr/bin/env python3
"""The JAX package's UNet3D gradient, jitted and eager, against the port's
and against float64 finite differences, on the CPU.

    python3 scripts/jax_jit_grad_check.py [--patch_size 64 64 48] [--leaf conv4.conv2.w]

One full-width UNet3D (NDHWC, dropout 0) from jax.random.key(11), a batch
of 4 ellipsoid volumes (2 labeled), the supervised loss (CE + binary Dice
on the labeled half) in training mode. Prints, for each encoder and centre
conv weight and up_concat1.conv1, the port's gradient and the jitted JAX
gradient each against the eager JAX one: the ratio of their projections
and max |diff| / max |eager|. Then, along the unit direction (jitted -
eager) of `--leaf`, the directional derivative by central differences of
the port's model in float64 (eps 1e-3 and 1e-4) beside each gradient's.
Last, the jitted gradient again with the JAX max pool (reshape + max)
swapped for lax.reduce_window: a wrong jitted gradient that this swap
repairs points at the jitted VJP of the reshape-and-max pool. Needs JAX;
the CPU only; ~4 minutes on 8 cores.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROWS = ("conv1.conv1.w", "conv1.conv2.w", "conv2.conv1.w", "conv2.conv2.w", "conv3.conv1.w",
        "conv3.conv2.w", "conv4.conv1.w", "conv4.conv2.w", "center.conv1.w",
        "center.conv2.w", "up_concat1.conv1.w")


def _flat(tree, prefix=""):
    import numpy as np

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float64)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--patch_size", type=int, nargs=3, default=(64, 64, 48))
    p.add_argument("--leaf", type=str, default="conv4.conv2.w")
    p.add_argument("--threads", type=int, default=8)
    args = p.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(args.threads)
    from dycon_paper_replication_tpu.models import unet3d as junet
    from dycon_paper_replication_tpu.models.unet3d import UNet3DConfig as JaxConfig
    from dycon_paper_replication_tpu.ops import losses as jlosses
    from dycon_paper_replication_tpu_torch import weights
    from dycon_paper_replication_tpu_torch.models import UNet3D, UNet3DConfig
    from dycon_paper_replication_tpu_torch.ops import losses as tlosses

    patch = tuple(args.patch_size)
    rng = np.random.default_rng(1)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in patch], indexing="ij"), -1)
    labels = []
    for _ in range(4):
        c, r = rng.uniform(0.3, 0.7, 3) * patch, rng.uniform(0.3, 0.5, 3) * patch
        labels.append((((grid - c) / r) ** 2).sum(-1) <= 1.0)
    label = np.stack(labels).astype(np.int32)
    image = (0.4 * label + 0.1 * rng.standard_normal(label.shape)).astype(np.float32)[..., None]

    cfg = JaxConfig(layout="NDHWC", dropout_rate=0.0)
    params, state = junet.init_unet3d(jax.random.key(11), cfg)

    def jax_loss(prm):
        (_, seg, _), _ = junet.unet3d_apply(prm, state, jnp.asarray(image), cfg, train=True,
                                            with_projection=False)
        probs = jax.nn.softmax(seg, -1)
        return (jlosses.cross_entropy_loss(seg[:2], jnp.asarray(label[:2]))
                + jlosses.dice_loss(probs[:2, ..., 1], jnp.asarray(label[:2]) == 1))

    eager = _flat(jax.grad(jax_loss)(params))
    jitted = _flat(jax.jit(jax.grad(jax_loss))(params))

    sd = weights.jax_tree_to_state_dict(*jax.tree.map(np.asarray, (params, state)))
    lab = torch.from_numpy(label).long()

    def port_model(dtype):
        net = UNet3D(UNet3DConfig(layout="NDHWC", dropout_rate=0.0, compute_dtype=dtype))
        net = net.to(dtype)
        net.load_state_dict({k: v.to(dtype) for k, v in sd.items()})
        return net.train()

    def port_loss(net, x):
        _, seg, _ = net(x, with_projection=False)
        probs = torch.softmax(seg, -1)
        return (tlosses.cross_entropy_loss(seg[:2], lab[:2])
                + tlosses.dice_loss(probs[:2, ..., 1], lab[:2] == 1))

    net32 = port_model(torch.float32)
    port_loss(net32, torch.from_numpy(image)).backward()
    port = {k: v.grad.double().numpy() for k, v in net32.named_parameters() if k in ROWS}

    def compare(got, want):
        a, b = got.ravel(), want.ravel()
        return float(a @ b / (b @ b)), float(np.abs(a - b).max() / np.abs(b).max())

    out = {"rows": {}}
    for name in ROWS:
        out["rows"][name] = dict(port=compare(port[name], eager[name]),
                                 jit=compare(jitted[name], eager[name]))
        print(f"{name}: port / eager {out['rows'][name]['port']}, "
              f"jit / eager {out['rows'][name]['jit']}")

    d = jitted[args.leaf] - eager[args.leaf]
    d /= np.linalg.norm(d)
    net64 = port_model(torch.float64)
    x64 = torch.from_numpy(image).double()
    leaf = dict(net64.named_parameters())[args.leaf]
    base = leaf.detach().clone()
    fd = {}
    with torch.no_grad():
        for eps in (1e-3, 1e-4):
            vals = []
            for sign in (1.0, -1.0):
                leaf.copy_(base + sign * eps * torch.from_numpy(d.reshape(base.shape)))
                vals.append(float(port_loss(net64, x64)))
            fd[eps] = (vals[0] - vals[1]) / (2 * eps)
        leaf.copy_(base)
    out["directional"] = dict(fd=fd, eager=float(eager[args.leaf].ravel() @ d.ravel()),
                              jit=float(jitted[args.leaf].ravel() @ d.ravel()),
                              port=float(port[args.leaf].ravel() @ d.ravel()))
    print(f"along (jit - eager) of {args.leaf}: float64 central differences {fd}, eager "
          f"{out['directional']['eager']}, jit {out['directional']['jit']}, port "
          f"{out['directional']['port']}")

    def pool_window(x, data_format="NDHWC"):
        return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 2, 2, 2, 1), (1, 2, 2, 2, 1),
                                     "VALID")

    real_pool = junet.max_pool_2x
    junet.max_pool_2x = pool_window
    try:
        windowed = _flat(jax.jit(jax.grad(jax_loss))(params))
    finally:
        junet.max_pool_2x = real_pool
    out["jit_reduce_window"] = {name: compare(windowed[name], eager[name]) for name in ROWS}
    print("jit with reduce_window pools / eager:", out["jit_reduce_window"])
    return out


if __name__ == "__main__":
    main()
