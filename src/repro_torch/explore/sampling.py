"""Space-filling designs, ported from ``repro.explore.sampling``: the
scrambled Sobol sequence the surrogate seeds its GP with (numpy only, so the
port's points equal the reference's)."""
from __future__ import annotations

import numpy as np


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
