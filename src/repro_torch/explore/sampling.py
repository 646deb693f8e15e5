"""Samplings — the design-of-experiments generators behind exploration
transitions, ported from ``repro.explore.sampling``. Each Sampling yields
Contexts binding Vals to values; the engine fans a task out over them. They
are numpy, as in the reference, so equal arguments give equal contexts; the
surrogate seeds its GP with the scrambled Sobol points.

Provided: full-factorial grid, uniform random, Latin hypercube, Sobol
(scrambled, direction numbers for <= 16 dims), and the paper's
``UniformDistribution[Int] take n`` seed sampling for replication.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np

from repro_torch.core.prototype import Context, Val


class Sampling:
    def provides(self) -> Sequence[Val]:
        raise NotImplementedError

    def contexts(self, base: Context) -> Iterator[Context]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    # DSL: sampling_a x sampling_b = cross product
    def __mul__(self, other: "Sampling") -> "CrossSampling":
        return CrossSampling(self, other)


@dataclasses.dataclass
class GridSampling(Sampling):
    """Full factorial over {val: list-of-values}."""
    axes: Dict[Val, Sequence]

    def provides(self):
        return list(self.axes)

    def __len__(self):
        n = 1
        for v in self.axes.values():
            n *= len(v)
        return n

    def contexts(self, base: Context) -> Iterator[Context]:
        names = [v.name for v in self.axes]
        for combo in itertools.product(*self.axes.values()):
            yield Context(dict(zip(names, combo)))


@dataclasses.dataclass
class UniformSampling(Sampling):
    """n iid uniform draws per bounded Val — LHS without stratification."""
    bounds: Dict[Val, Tuple[float, float]]
    n: int
    seed: int = 0

    def provides(self):
        return list(self.bounds)

    def __len__(self):
        return self.n

    def contexts(self, base: Context) -> Iterator[Context]:
        rng = np.random.default_rng(self.seed)
        draws = {v.name: rng.uniform(lo, hi, self.n)
                 for v, (lo, hi) in self.bounds.items()}
        for i in range(self.n):
            yield Context({k: float(a[i]) for k, a in draws.items()})


@dataclasses.dataclass
class LHSSampling(Sampling):
    """Latin hypercube: stratified uniform per dim, shuffled."""
    bounds: Dict[Val, Tuple[float, float]]
    n: int
    seed: int = 0

    def provides(self):
        return list(self.bounds)

    def __len__(self):
        return self.n

    def contexts(self, base: Context) -> Iterator[Context]:
        rng = np.random.default_rng(self.seed)
        cols = {}
        for v, (lo, hi) in self.bounds.items():
            strata = (np.arange(self.n) + rng.uniform(size=self.n)) / self.n
            rng.shuffle(strata)
            cols[v.name] = lo + strata * (hi - lo)
        for i in range(self.n):
            yield Context({k: float(a[i]) for k, a in cols.items()})


def _sobol_points(n: int, dim: int, seed: int = 0) -> np.ndarray:
    """Scrambled Sobol in [0,1)^dim via numpy (Joe-Kuo first dims)."""
    # direction numbers for the first 16 dims (primitive polynomials)
    polys = [0, 1, 1, 2, 1, 4, 2, 4, 7, 11, 13, 14, 1, 13, 16, 19]
    m_init = [[1], [1], [1, 3], [1, 3, 1], [1, 1], [1, 1, 3], [1, 3, 5, 13],
              [1, 1, 5, 5], [1, 1, 5, 5, 17], [1, 1, 7, 11, 19],
              [1, 1, 5, 1, 1], [1, 1, 1, 3, 11], [1, 3, 5, 5, 31],
              [1, 3, 3, 9, 7, 49], [1, 1, 1, 15, 21, 21], [1, 3, 1, 13, 27, 49]]
    assert dim <= len(polys), f"sobol dims <= {len(polys)}"
    bits = max(int(np.ceil(np.log2(max(n, 2)))), 1) + 1
    out = np.zeros((n, dim))
    rng = np.random.default_rng(seed)
    for d in range(dim):
        s = len(m_init[d])
        m = list(m_init[d])
        a = polys[d]
        for i in range(s, bits):
            newm = m[i - s]
            for k in range(1, s + 1):
                if (a >> (s - 1 - (k - 1))) & 1 or k == s:
                    newm ^= m[i - k] << k
            m.append(newm)
        v = [m[i] << (31 - i) for i in range(bits)]   # 32-bit direction nums
        x = 0
        seq = np.zeros(n, np.uint64)
        for i in range(n):
            # Gray-code construction: flip the direction number of the
            # lowest zero bit of i
            j, ii = 0, i
            while ii & 1:
                j += 1
                ii >>= 1
            x ^= v[j]
            seq[i] = x
        shift = int(rng.integers(0, 1 << 32, dtype=np.int64))  # scramble
        out[:, d] = ((seq ^ np.uint64(shift)) & np.uint64((1 << 32) - 1)) \
            / float(1 << 32)
    return out


@dataclasses.dataclass
class SobolSampling(Sampling):
    bounds: Dict[Val, Tuple[float, float]]
    n: int
    seed: int = 0

    def provides(self):
        return list(self.bounds)

    def __len__(self):
        return self.n

    def contexts(self, base: Context) -> Iterator[Context]:
        pts = _sobol_points(self.n, len(self.bounds), self.seed)
        names = [v.name for v in self.bounds]
        spans = [(lo, hi) for lo, hi in self.bounds.values()]
        for i in range(self.n):
            yield Context({
                names[d]: float(spans[d][0]
                                + pts[i, d] * (spans[d][1] - spans[d][0]))
                for d in range(len(names))})


@dataclasses.dataclass
class SeedSampling(Sampling):
    """The paper's ``seed in (UniformDistribution[Int]() take 5)``."""
    val: Val
    n: int
    seed: int = 0

    def provides(self):
        return [self.val]

    def __len__(self):
        return self.n

    def contexts(self, base: Context) -> Iterator[Context]:
        rng = np.random.default_rng(self.seed)
        for s in rng.integers(0, 2 ** 31 - 1, self.n):
            yield Context({self.val.name: int(s)})


class CrossSampling(Sampling):
    def __init__(self, a: Sampling, b: Sampling):
        self.a, self.b = a, b

    def provides(self):
        return list(self.a.provides()) + list(self.b.provides())

    def __len__(self):
        return len(self.a) * len(self.b)

    def contexts(self, base: Context) -> Iterator[Context]:
        for ca in self.a.contexts(base):
            for cb in self.b.contexts(base):
                yield ca.merged(cb)
