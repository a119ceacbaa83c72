"""JAX's counter-based random streams (threefry2x32), drawn bit for bit.

The JAX package's `--seed` fixes its initial weights (jax.random.key(seed)
through the split trees of models/*.py), the teacher noise
(jax.random.normal) and the dropout masks (jax.random.bernoulli). This
module draws the same numbers, so that the port's `--seed` means the same
run. It follows jax/_src/prng.py with `jax_threefry_partitionable` on (the
default since JAX 0.5):

  * a key is two uint32 words, here a numpy array of shape (2,) on the host;
    `key(seed)` is (0, seed mod 2**32), as jax.random.key makes it with
    64-bit types off (the JAX package's setting);
  * `split(k, n)`: key i is the hash of the counter (0, i) under k
    (_threefry_split_foldlike);
  * `fold_in(k, d)`: the hash of the counter pair (0, d) under k, its two
    outputs the new key (_threefry_fold_in);
  * `bits(k, shape)`: element i of the flat shape hashes the counter
    (i >> 32, i & 0xffffffff) and takes out0 ^ out1
    (_threefry_random_bits_partitionable);
  * `uniform`: the top 23 bits as a float32 mantissa in [1, 2), minus 1,
    scaled to [lo, hi) (random.py:_uniform); `bernoulli(p)` is
    uniform < p (_bernoulli); `normal` is sqrt(2) erfinv(u) with u uniform
    in [nextafter(-1, 0), 1) (_normal_real), erfinv being XLA's float32
    polynomial (Giles), within a few ulp of JAX's where log1p rounds
    differently. XLA fuses a * b + c into one rounding; so does `_fma`.

Since element i depends only on (key, i), a data-parallel rank draws its own
rows of the global tensor (`rows`: the global row of each local row) and a
recompute draws the same numbers from the same key. The key operations run
on the host in numpy; the draws have a numpy version (`device=None`, what
weights.init_jax_tree uses) and a torch one on any device, doing uint32
arithmetic in int64 with masks. The kernel on the card
(ops/csrc/threefry.cu, the wrappers `teacher_noise` and `dropout`) draws the
step's noise and dropout masks; on a CPU tensor the wrappers take the torch
version here.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import numpy as np
import torch

from . import _build

SOURCE = _build.CSRC / "threefry.cu"
M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
NOISE_STD, NOISE_CLIP = 0.1, 0.2  # the teacher noise: clip(0.1 N(0, 1), +-0.2)


def _hash(k0: int, k1: int, x0, x1):
    """threefry2x32 of the counter pairs (x0, x1) under the key (k0, k1):
    20 rounds, the key injected every 4. x0, x1 are numpy uint32 arrays,
    which wrap by themselves and are updated in place (the host's init draws
    millions), or torch int64 tensors holding uint32 values, masked; returns
    the two output words so."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    if isinstance(x0, np.ndarray):
        x0, x1, tmp = x0.astype(np.uint32), x1.astype(np.uint32), np.empty(x1.shape, np.uint32)
        x0 += np.uint32(ks[0])
        x1 += np.uint32(ks[1])
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                np.left_shift(x1, np.uint32(r), out=tmp)
                x1 >>= np.uint32(32 - r)
                x1 |= tmp
                x1 ^= x0
            x0 += np.uint32(ks[(i + 1) % 3])
            x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & M32)
        return x0, x1
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int) -> np.ndarray:
    """jax.random.key(seed)'s two words (module doc)."""
    return np.array([0, int(seed) & M32], np.uint32)


def _words(k) -> tuple[int, int]:
    k = np.asarray(k, np.uint32)
    return int(k[0]), int(k[1])


def split(k, n: int = 2) -> np.ndarray:
    """jax.random.split(k, n): (n, 2) uint32."""
    o0, o1 = _hash(*_words(k), np.zeros(n, np.uint64), np.arange(n, dtype=np.uint64))
    return np.stack([o0, o1], axis=1).astype(np.uint32)


def fold_in(k, data: int) -> np.ndarray:
    """jax.random.fold_in(k, data) for 0 <= data < 2**32."""
    o0, o1 = _hash(*_words(k), np.zeros(1, np.uint64), np.array([int(data) & M32], np.uint64))
    return np.array([o0[0], o1[0]], np.uint32)


def _counters(shape: Sequence[int], rows, device):
    """The flat indices of `shape`'s elements (all of them, or those of the
    global rows `rows` along axis 0), as (hi, lo) words, in the shape they
    are drawn in."""
    shape = tuple(int(s) for s in shape)
    inner = math.prod(shape[1:])
    if device is None:
        if rows is None:
            idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
        else:
            r = np.asarray(rows, np.uint64).reshape(-1, *([1] * (len(shape) - 1)))
            idx = r * np.uint64(inner) + np.arange(inner, dtype=np.uint64).reshape(shape[1:])
        return idx >> np.uint64(32), idx & np.uint64(M32)
    if rows is None:
        idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(shape)
    else:
        r = torch.as_tensor(np.asarray(rows, np.int64), device=device)
        idx = (r.reshape(-1, *([1] * (len(shape) - 1))) * inner
               + torch.arange(inner, dtype=torch.int64, device=device).reshape(shape[1:]))
    return idx >> 32, idx & M32


def bits(k, shape: Sequence[int], rows=None, device=None):
    """jax.random.bits(k, shape) (uint32), or its rows `rows` along axis 0.
    numpy uint32 with `device` None; else an int64 tensor of uint32 values on
    `device`."""
    hi, lo = _counters(shape, rows, device)
    o0, o1 = _hash(*_words(k), hi, lo)
    return o0 ^ o1


def _unit(b, device):
    """Uniform [0, 1) float32 from 32 random bits: the top 23 as the
    mantissa of a float in [1, 2), minus 1."""
    m = (b >> 9) | 0x3F800000
    if device is None:
        return m.view(np.float32) - np.float32(1.0)
    return m.to(torch.int32).view(torch.float32) - 1.0


def _fma(a, b, c):
    """a * b + c rounded once to float32, as XLA fuses it: a * b is exact in
    float64 for float32 a and b, and so is the sum at the magnitudes drawn
    here (a double rounding would need an exact float32 tie). b is a float
    or an array or tensor like a."""
    if isinstance(a, np.ndarray):
        return (a.astype(np.float64) * np.asarray(b, np.float64) + c).astype(np.float32)
    if isinstance(b, torch.Tensor):
        b = b.double()
    return (a.double() * b + c).float()


def uniform(k, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0, rows=None,
            device=None):
    """jax.random.uniform(k, shape, float32, minval, maxval): [0, 1) times
    float32(maxval - minval) plus minval in one rounding, no less than
    minval."""
    u = _unit(bits(k, shape, rows, device), device)
    lo, hi = np.float32(minval), np.float32(maxval)
    span = np.float32(hi - lo)
    if (lo, span) == (0.0, 1.0):
        return u
    v = _fma(u, float(span), float(lo))
    return np.maximum(lo, v) if device is None else torch.clamp_min(v, float(lo))


def bernoulli(k, p: float, shape: Sequence[int], rows=None, device=None):
    """jax.random.bernoulli(k, p, shape): uniform < float32(p)."""
    u = uniform(k, shape, rows=rows, device=device)
    return u < (np.float32(p) if device is None else float(np.float32(p)))


# XLA's float32 erfinv (Giles): a polynomial in w - 2.5 for w < 5, else in
# sqrt(w) - 3, with w = -log1p(-x^2)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def erfinv_f32(x):
    """XLA's float32 erfinv of a float32 array or tensor, each step of the
    polynomials one fused multiply-add (in numpy, each branch's polynomial
    only where it is taken: the host's init draws millions)."""
    if isinstance(x, np.ndarray):
        w = -np.log1p(-x * x)
        small = w < np.float32(5.0)
        out = np.empty_like(x)
        for where, v, coeffs in ((small, w[small] - np.float32(2.5), _ERFINV_SMALL),
                                 (~small, np.sqrt(w[~small]) - np.float32(3.0), _ERFINV_LARGE)):
            v64, p = v.astype(np.float64), np.full(v.shape, coeffs[0], np.float32)
            for c in coeffs[1:]:
                p = (p * v64 + float(np.float32(c))).astype(np.float32)
            out[where] = p
        return out * x
    w = -torch.log1p(-x * x)
    small = w < 5.0
    ws, wl = w - 2.5, torch.sqrt(w) - 3.0
    ps, pl = torch.full_like(x, _ERFINV_SMALL[0]), torch.full_like(x, _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        ps = _fma(ps, ws, float(np.float32(cs)))
        pl = _fma(pl, wl, float(np.float32(cl)))
    return torch.where(small, ps, pl) * x


def normal(k, shape: Sequence[int], rows=None, device=None):
    """jax.random.normal(k, shape) in float32 (module doc: within a few ulp)."""
    u = uniform(k, shape, NORMAL_LO, 1.0, rows, device)
    root2 = np.float32(math.sqrt(2.0))
    return erfinv_f32(u) * (root2 if device is None else float(root2))


# --- the step's draws: the kernel on the card, the torch version on the CPU ---


def noise_plain(k, shape: Sequence[int], rows=None, device=None) -> torch.Tensor:
    """The teacher noise clip(0.1 normal(k, shape), +-0.2) in float32, as a
    tensor on `device` (the CPU by default): train/step.py's draw."""
    z = normal(k, shape, rows, device=torch.device("cpu") if device is None else device)
    return (float(np.float32(NOISE_STD)) * z).clamp(-NOISE_CLIP, NOISE_CLIP)


def _div(x: torch.Tensor, keep: float) -> torch.Tensor:
    """x / keep as JAX divides: by keep rounded to x's dtype, the quotient
    rounded once to it (a bf16 one computed in float32). The divisor is a
    tensor on x's device: by a host scalar, CUDA multiplies by its
    reciprocal instead."""
    wide = x.dtype if x.dtype in (torch.float32, torch.float64) else torch.float32
    d = torch.tensor(keep, dtype=x.dtype).to(device=x.device, dtype=wide)
    return (x.to(wide) / d).to(x.dtype)


def dropout_plain(x: torch.Tensor, k, keep: float, rows=None) -> torch.Tensor:
    """where(bernoulli(k, keep, shape), x / keep, 0) in x's dtype
    (models/layers.py's JAX dropout); `rows` the global rows of x's rows."""
    mask = bernoulli(k, keep, x.shape, rows=rows, device=x.device)
    return torch.where(mask, _div(x, keep), torch.zeros((), dtype=x.dtype, device=x.device))


def _row_segments(rows, n: int) -> tuple[int, int, int]:
    """(split, off0, off1): global row of local row j is off0 + j for
    j < split, else off1 + j - split: the form of a data-parallel rank's rows
    (its labeled rows, then its unlabeled ones), which the kernel takes."""
    if rows is None:
        return n, 0, 0
    r = [int(v) for v in rows]
    if len(r) != n:
        raise ValueError(f"{len(r)} rows given for a tensor of {n}")
    split = next((j for j in range(1, n) if r[j] != r[j - 1] + 1), n)
    if any(r[j] != r[split] + j - split for j in range(split, n)):
        raise ValueError(f"rows {r} are not two contiguous runs")
    return split, r[0], r[split] if split < n else 0


class NoiseKernel:
    """The kernel's teacher noise: clip(0.1 normal, +-0.2) float32 over an
    (B, ...) shape's rows `rows`; counts one launch a call on CUDA."""

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            self._fn = _build.function(SOURCE, "dycon_threefry_noise",
                                       [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                                        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p])
        return self._fn

    def __call__(self, k, shape: Sequence[int], rows=None,
                 device: torch.device | str = "cpu") -> torch.Tensor:
        device = torch.device(device)
        if device.type == "cpu":
            return noise_plain(k, shape, rows, device)
        return self.launch(k, shape, rows, device)

    def launch(self, k, shape, rows, device) -> torch.Tensor:
        n = len(rows) if rows is not None else int(shape[0])
        out = torch.empty((n,) + tuple(shape[1:]), dtype=torch.float32, device=device)
        split, off0, off1 = _row_segments(rows, n)
        inner = math.prod(shape[1:])
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._kernel()(out.data_ptr(), *_words(k), n, inner, split, off0, off1,
                                 stream)
        if err != 0:
            raise RuntimeError(f"threefry noise: kernel launch failed, cudaError {err}")
        self.launches += 1
        return out


class DropoutKernel:
    """The kernel's fused dropout, y = where(u < keep, x / keep, 0) with u
    drawn from the key at each element's flat index (of the global rows
    `rows`), float32 or bf16. The backward is the same function of the
    cotangent with the same key, so no mask is kept. Counts one launch a
    call on CUDA, forward or backward."""

    def __init__(self):
        self.launches = 0
        self._fns = {}

    def _kernel(self, dtype: torch.dtype):
        if dtype not in self._fns:
            name = {torch.float32: "dycon_threefry_dropout_f32",
                    torch.bfloat16: "dycon_threefry_dropout_bf16"}[dtype]
            self._fns[dtype] = _build.function(
                SOURCE, name, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
                               ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
                               ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_void_p])
        return self._fns[dtype]

    def __call__(self, x: torch.Tensor, k, keep: float, rows=None) -> torch.Tensor:
        if x.device.type == "cpu":
            return dropout_plain(x, k, keep, rows)
        return self.launch(x, k, keep, rows)

    def launch(self, x: torch.Tensor, k, keep: float, rows=None) -> torch.Tensor:
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"threefry dropout: dtype {x.dtype} is not float32 or bfloat16")
        if not x.is_contiguous() or x.dim() < 1:
            raise ValueError("threefry dropout: the input must be contiguous, element i at "
                             "its flat index in JAX's layout")
        out = torch.empty_like(x)
        n = x.shape[0]
        split, off0, off1 = _row_segments(rows, n)
        divisor = float(torch.tensor(keep, dtype=x.dtype))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = self._kernel(x.dtype)(x.data_ptr(), out.data_ptr(), *_words(k),
                                        float(np.float32(keep)), divisor, n,
                                        x.numel() // max(n, 1), split, off0, off1, stream)
        if err != 0:
            raise RuntimeError(f"threefry dropout: kernel launch failed, cudaError {err}")
        self.launches += 1
        return out


teacher_noise = NoiseKernel()
dropout_kernel = DropoutKernel()


class DropoutFn(torch.autograd.Function):
    """Dropout whose backward redraws the mask from the key (module doc)."""

    @staticmethod
    def forward(ctx, x, k, keep, rows):
        ctx.k, ctx.keep, ctx.rows = k, keep, rows
        return dropout_kernel(x.contiguous(), k, keep, rows)

    @staticmethod
    def backward(ctx, dy):
        return dropout_kernel(dy.contiguous(), ctx.k, ctx.keep, ctx.rows), None, None, None


def dropout(x: torch.Tensor, k, keep: float, rows=None) -> torch.Tensor:
    """The JAX layer's inverted dropout with key `k` (module doc), through
    the kernel on CUDA; differentiable."""
    return DropoutFn.apply(x, k, keep, rows)
