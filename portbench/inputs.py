"""The general generator: every request's inputs from a traffic file's
`draws`, the run's seed and the request's index.

A draw is one of
    {"uniform": [lo, hi]}                 a float in [lo, hi)
    {"uniform": [lo, hi], "shape": [m]}   a list of them
    {"integers": [lo, hi], "shape": [m]}  integers in [lo, hi], both ends in
    {"normal": [mean, std], "shape": [m]}
and the same (seed, index) gives the same values on either side of the
comparison.  The warm-up request has its own index, WARM."""

import numpy as np

WARM = 2 ** 40  # the index of the set-up's warm request; the profiled ones follow it


def draw(draws, seed, k):
    """{name: value} for request k of a run seeded `seed`."""
    rng = np.random.default_rng([int(seed) % 2 ** 64, int(k)])
    out = {}
    for name in sorted(draws):
        spec = draws[name]
        shape = tuple(spec.get("shape", ()))
        if "uniform" in spec:
            lo, hi = spec["uniform"]
            v = rng.uniform(lo, hi, size=shape)
        elif "integers" in spec:
            lo, hi = spec["integers"]
            v = rng.integers(lo, hi + 1, size=shape)
        elif "normal" in spec:
            mean, std = spec["normal"]
            v = rng.normal(mean, std, size=shape)
        else:
            raise ValueError(f"draw {name!r}: unknown kind {sorted(spec)}")
        out[name] = v.tolist() if shape else float(v)
    return out


def sine_field(d, n, device, dtype):
    """The (n+1)^3 grid field sum_m amp_m sin(pi fx_m x) sin(pi fy_m y)
    sin(2 pi fz_m z) at the points (i, j, k) / n, from the draws `amp`,
    `fx`, `fy`, `fz` (one entry per mode)."""
    import torch

    t = torch.arange(n + 1, dtype=torch.float64, device=device) / n
    u = torch.zeros((n + 1,) * 3, dtype=torch.float64, device=device)
    for a, p, q, r in zip(d["amp"], d["fx"], d["fy"], d["fz"]):
        u += (a * torch.sin(np.pi * p * t)[:, None, None] * torch.sin(np.pi * q * t)[None, :, None]
              * torch.sin(2 * np.pi * r * t)[None, None, :])
    return u.to(dtype)


def probe_vector(seed, k, size, device, dtype):
    """A seeded vector of normal entries on which an operator's action is
    compared (the same on both sides)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed((int(seed) * 7919 + int(k)) % 2 ** 63)
    return torch.randn(size, generator=g, dtype=torch.float64).to(device=device, dtype=dtype)
