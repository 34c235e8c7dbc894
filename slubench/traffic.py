"""The one traffic generator: every mix is a data file of its parameters.

A mix file (``slubench/traffic/<mix>.json``) names its ``generator`` and
the ``driver`` loop that its work feeds; a later generator is another
function here, and a mix that names it another data file. Sizes come from the mix's fixed
``shape_seed``, so every run seed gets the same set of sizes; the run seed
orders them and makes the content (waveforms, labels).

* ``closed``: ``pool`` requests for a closed loop of ``clients`` clients:
  lengths ``length_min_s`` + Gamma(``gamma_shape``, scale) s with the
  scale that gives a mean of ``length_mean_s``, cut at ``length_max_s``;
  client c sends requests c, c + clients, c + 2 clients, ... of the pool
  (cycled), each as soon as its previous answer comes.
"""

from __future__ import annotations

import numpy as np
import torch

def check_generator(mix: dict, want: str) -> None:
    """Raise unless the mix names the generator its driver runs."""
    if mix.get("generator") != want:
        raise ValueError(f"this driver runs the {want!r} generator; the mix names {mix.get('generator')!r}")


def sub_seed(seed: int, stream: int) -> int:
    """A 32-bit seed of stream ``stream`` (weights, content, order, ...) of
    run seed ``seed`` (any non-negative integer)."""
    return int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(1)[0])


def bucket(n: int, quant: int) -> int:
    """The smallest multiple of ``quant`` holding ``n`` samples (at least one)."""
    return max(quant, -(-n // quant) * quant)


def request_lengths(mix: dict) -> np.ndarray:
    """(pool,) sample counts of a closed-loop mix, the same for every run seed."""
    rng = np.random.default_rng(mix["shape_seed"])
    lo, hi, mean, k = mix["length_min_s"], mix["length_max_s"], mix["length_mean_s"], mix["gamma_shape"]
    s = np.minimum(lo + rng.gamma(k, (mean - lo) / k, mix["pool"]), hi)
    return np.round(mix["fs"] * s).astype(np.int64)


def closed_requests(mix: dict, seed: int, device) -> list[np.ndarray]:
    """The request pool of run ``seed``: the mix's lengths in the seed's
    order, each a waveform of seeded noise (made on ``device`` in one call,
    handed over as host float32 arrays, as clients send them)."""
    lengths = request_lengths(mix)[np.random.default_rng(sub_seed(seed, 1)).permutation(mix["pool"])]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    flat = (mix["amplitude"] * torch.randn(int(lengths.sum()), generator=gen, device=device)).cpu().numpy()
    cuts = np.cumsum(lengths)[:-1]
    return np.split(flat, cuts)


def client_request(mix: dict, client: int, k: int) -> int:
    """Pool index of client ``client``'s ``k``-th request."""
    return (client + mix["clients"] * k) % mix["pool"]

