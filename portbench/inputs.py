"""Float weights and images of a run, made from ``--seed``.

The random numbers come from a ``torch.Generator`` on the run's device, in
one call per kind; the weights are then shaped and scaled per layer and
handed, the same float32 arrays, to the program and to the reference.
Each kind draws from its own stream of the seed, so a longer pool of
images leaves the weights alone.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_WEIGHTS, _CALIBRATION, _POOL, _ORDER = range(4)


def sub_seed(seed: int, stream: int) -> int:
    """A 64-bit seed of ``stream`` from the run's seed (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, stream])
    return int(ss.generate_state(1, np.uint64)[0])


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def weights(lyrs, seed: int, device) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """He-scaled normal weights with a per-output-channel gain in [0.5, 1.5)
    (a folded BatchNorm's spread) and biases in [-0.1, 0.1); the classifier
    is scaled by 1 / fan_in."""
    with_w = [lyr for lyr in lyrs if lyr.weight_shape is not None]
    n_w = sum(math.prod(lyr.weight_shape) for lyr in with_w)
    n_c = sum(lyr.cout for lyr in with_w)
    g = _generator(seed, _WEIGHTS, device)
    raw = torch.randn(n_w, generator=g, device=device).cpu().numpy()
    per_ch = torch.rand(2 * n_c, generator=g, device=device).cpu().numpy()
    out = {}
    at = ac = 0
    for lyr in with_w:
        shape = lyr.weight_shape
        n = math.prod(shape)
        w = raw[at:at + n].reshape(shape)
        gain = 0.5 + per_ch[ac:ac + lyr.cout]
        bias = 0.2 * per_ch[n_c + ac:n_c + ac + lyr.cout] - 0.1
        at, ac = at + n, ac + lyr.cout
        if lyr.kind == "linear":
            w = w * (gain[None, :] / math.sqrt(lyr.fan_in))
        else:
            w = w * (gain[:, None, None, None] * math.sqrt(2.0 / lyr.fan_in))
        out[lyr.name] = (np.ascontiguousarray(w, np.float32),
                         bias.astype(np.float32))
    return out


def images(shape, n: int, seed: int, stream: int, device) -> np.ndarray:
    """``n`` standard-normal float32 images of ``shape`` (C, H, W)."""
    g = _generator(seed, stream, device)
    return torch.randn((n, *shape), generator=g,
                       device=device).cpu().numpy()


def calibration(shape, n: int, seed: int, device) -> np.ndarray:
    return images(shape, n, seed, _CALIBRATION, device)


def pool(shape, n: int, seed: int, device) -> np.ndarray:
    return images(shape, n, seed, _POOL, device)


def order_rng(seed: int) -> np.random.Generator:
    """The host generator of a run's traffic order (arrival order, which
    image each request carries)."""
    return np.random.default_rng(sub_seed(seed, _ORDER))
