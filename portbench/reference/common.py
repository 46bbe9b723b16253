"""Plain PyTorch pieces that the reference models share.

Everything here is written from the published model description and the
benchmark's own inputs, in float32, with no kernel, cache or batching of
the program under test. It imports nothing of the program.

- The scene as the classifier sees it: each modality padded symmetrically
  by the neighborhood, CASI min/max-normalized per band and LiDAR as a
  whole, then windows cut by plain indexing.
- tf-slim layers: a linear map (with a bias only where no batch norm
  follows), batch norm with a bias and no scale (eps 1e-3), leaky ReLU
  with slope ``alpha`` below zero.
- Dropout, augmentation and the epoch index stream, drawn from seeds that
  the benchmark derives the way the training recipe states (a generator
  per (seed, purpose, step)).
- Adam with b1 0.9, b2 0.999, eps 1e-8 and the staircase learning rate.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

BN_EPSILON = 1e-3


class Param(NamedTuple):
    """One tensor of a model: its state-dict name, shape and initializer
    (``he_truncated``, ``xavier``, ``zeros`` or ``ones``)."""
    name: str
    shape: tuple
    init: str


class Op(NamedTuple):
    """A product of the model, for counting its work: ``kind`` is ``conv``
    or ``dense``; ``macs`` its multiply-adds for one window; ``train_only``
    whether it runs in training alone; ``reads_input`` whether it reads the
    model's input, whose gradient training does not need."""
    kind: str
    macs: int
    train_only: bool = False
    reads_input: bool = False


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products with TF32 off (``tf32=False``), or on, for the
    control; the flags are given back after the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---- the scene ----

def padded_scene(casi: np.ndarray, lidar: np.ndarray, neighborhood: int, device) -> torch.Tensor:
    """The ``[H + 2n, W + 2n, bands + 1]`` float32 scene: each modality padded
    symmetrically (edge pixels repeated), CASI normalized per band by its
    padded minimum and range, LiDAR by its own."""
    n = neighborhood

    def pad(t: torch.Tensor) -> torch.Tensor:
        # symmetric padding mirrors including the edge pixel
        rows = torch.cat([t[:n].flip(0), t, t[t.shape[0] - n:].flip(0)], dim=0) if n else t
        return torch.cat([rows[:, :n].flip(1), rows, rows[:, rows.shape[1] - n:].flip(1)],
                         dim=1) if n else rows

    c = pad(torch.from_numpy(casi).to(device).to(torch.int32))
    c_min = c.amin(dim=(0, 1))
    c = c - c_min
    c = c.to(torch.float32) / c.amax(dim=(0, 1)).to(torch.float32)
    li = pad(torch.from_numpy(np.ascontiguousarray(lidar, dtype=np.float32)).to(device))
    li = li - li.min()
    li = li / li.max()
    return torch.cat([c, li], dim=2).contiguous()


def windows(scene: torch.Tensor, xy: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, k, k, C]`` windows whose top-left corner in the padded scene is
    (x, y): the window centred on pixel (x, y) of the unpadded scene."""
    offs = torch.arange(k, device=scene.device)
    xy = xy.to(device=scene.device, dtype=torch.int64)
    ys = xy[:, 1, None] + offs
    xs = xy[:, 0, None] + offs
    return scene[ys[:, :, None], xs[:, None, :]]


# ---- layers ----

def leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """``x`` where ``x >= 0``, else ``alpha * x``."""
    return torch.where(x >= 0, x, alpha * x)


class Norms:
    """How batch norm normalizes in one forward: ``"running"`` with the
    stored statistics, ``"batch"`` with the batch's moments. With
    ``record`` the batch moments of each layer are written into ``record``
    under the layer's names (to set running statistics from a batch)."""

    def __init__(self, mode: str, record: Optional[Dict[str, torch.Tensor]] = None):
        self.mode = mode
        self.record = record


def batch_norm(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor, norms: Norms) -> torch.Tensor:
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if norms.mode == "batch":
        dims = [0, *range(2, x.dim())]
        mean = x.mean(dims)
        var = ((x - mean.view(shape)) ** 2).mean(dims)
        if norms.record is not None:
            norms.record[f"{name}.mean"] = mean.detach()
            norms.record[f"{name}.var"] = var.detach()
    else:
        mean, var = w[f"{name}.mean"], w[f"{name}.var"]
    return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPSILON) \
        + w[f"{name}.bias"].view(shape)


def conv(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor, norms: Optional[Norms],
         act) -> torch.Tensor:
    """SAME convolution (odd kernel), then batch norm where ``norms`` is
    given (no conv bias then), then ``act``."""
    weight = w[f"{name}.Conv_0.weight"]
    bias = None if norms is not None else w[f"{name}.Conv_0.bias"]
    y = F.conv2d(x, weight, bias, padding=weight.shape[-1] // 2)
    if norms is not None:
        y = batch_norm(w, f"{name}.BatchNorm_0", y, norms)
    return y if act is None else act(y)


def dense(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor, norms: Optional[Norms],
          act) -> torch.Tensor:
    bias = None if norms is not None else w[f"{name}.Dense_0.bias"]
    y = F.linear(x, w[f"{name}.Dense_0.weight"], bias)
    if norms is not None:
        y = batch_norm(w, f"{name}.BatchNorm_0", y, norms)
    return y if act is None else act(y)


def conv_params(name: str, cin: int, cout: int, k: int, norm: bool, init: str) -> List[Param]:
    out = [Param(f"{name}.Conv_0.weight", (cout, cin, k, k), init)]
    return out + (bn_params(f"{name}.BatchNorm_0", cout) if norm else
                  [Param(f"{name}.Conv_0.bias", (cout,), "zeros")])


def dense_params(name: str, cin: int, cout: int, norm: bool, init: str) -> List[Param]:
    out = [Param(f"{name}.Dense_0.weight", (cout, cin), init)]
    return out + (bn_params(f"{name}.BatchNorm_0", cout) if norm else
                  [Param(f"{name}.Dense_0.bias", (cout,), "zeros")])


def bn_params(name: str, features: int) -> List[Param]:
    return [Param(f"{name}.bias", (features,), "zeros"), Param(f"{name}.mean", (features,), "zeros"),
            Param(f"{name}.var", (features,), "ones")]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and scale it up by
    that; the uniform draws are float32, in the batch's row-major order."""
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def match_channels(inp: torch.Tensor, out_ch: int) -> torch.Tensor:
    """The residual's shape matcher: each input channel repeated in place
    where the widths divide, else the nearest input channel
    (``round(i * in / out)``, halves to even, capped at the last)."""
    in_ch = inp.shape[1]
    if in_ch == out_ch:
        return inp
    if out_ch % in_ch == 0:
        return torch.repeat_interleave(inp, out_ch // in_ch, dim=1)
    idx = [min(round(i * in_ch / out_ch), in_ch - 1) for i in range(out_ch)]
    return inp[:, torch.tensor(idx, device=inp.device)]


def cross_entropy(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return -(onehot * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


# ---- seeds and draws ----

def purpose_seed(seed: int, purpose: str, step: int) -> int:
    """The seed of the generator that draws for (seed, purpose, step):
    the first 8 bytes of BLAKE2s of ``"{seed}/{purpose}/{step}"``,
    little-endian, below 2**63."""
    digest = hashlib.blake2s(f"{seed}/{purpose}/{int(step)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def generator(seed: int, purpose: str, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(purpose_seed(seed, purpose, step))


def epoch_rows(seed: int, count: int, batch: int, steps: int) -> np.ndarray:
    """``[steps, batch]`` rows of the training targets: the targets shuffled
    anew every epoch, by a NumPy generator seeded with ``seed`` XOR the
    first 4 bytes of BLAKE2s of ``"epoch-shuffle"``."""
    tag = int.from_bytes(hashlib.blake2s(b"epoch-shuffle", digest_size=4).digest(), "little")
    rng = np.random.default_rng(np.uint32(seed) ^ np.uint32(tag))
    needed = steps * batch
    perms = np.concatenate([rng.permutation(count) for _ in range(math.ceil(needed / count))])
    return perms[:needed].reshape(steps, batch)


def augment(patches: torch.Tensor, aug: Dict, gen: torch.Generator) -> torch.Tensor:
    """Rotation by 0, 90 or 180 degrees, a left-right then an up-down flip
    each with probability 1/2, then a spectral delta uniform in
    ``[-amount, 0)`` per window and channel; drawn from ``gen`` in that
    order, each only where it is on."""
    batch, channels = patches.shape[0], patches.shape[-1]
    dev = patches.device
    if aug.get("rotation"):
        turns = torch.randint(0, 3, (batch,), generator=gen, device=dev)
        rotated = [torch.rot90(patches, t, dims=(1, 2)) for t in range(3)]
        sel = turns.view(-1, 1, 1, 1)
        patches = torch.where(sel == 1, rotated[1], torch.where(sel == 2, rotated[2], rotated[0]))
    if aug.get("reflection"):
        lr = torch.rand((batch,), generator=gen, device=dev) < 0.5
        ud = torch.rand((batch,), generator=gen, device=dev) < 0.5
        patches = torch.where(lr.view(-1, 1, 1, 1), patches.flip(2), patches)
        patches = torch.where(ud.view(-1, 1, 1, 1), patches.flip(1), patches)
    amount = float(aug.get("spectral", 0.0))
    if amount:
        deltas = torch.rand((batch, 1, 1, channels), generator=gen, device=dev,
                            dtype=torch.float32) * amount - amount
        patches = patches + deltas
    return patches


class Adam:
    """Adam on a list of tensors, with the learning rate of each update
    given: ``p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``."""

    def __init__(self, params: Sequence[torch.Tensor], b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))


def staircase_lr(params: Dict, count: int) -> float:
    """``learning_rate * decay_factor ** floor(count / decay_step)``: the
    rate of the update that follows ``count`` updates."""
    return float(params["learning_rate"]) * float(params["learning_rate_decay_factor"]) ** \
        math.floor(count / params["learning_rate_decay_step"])
