"""Eigenspace projectors for BasisNet.

Port of signnet_basisnet_tpu/spectral/projectors.py: eigenvalues rounded to
5 decimals (`round_eigvals`, the reference's `around`), equal values
grouped into eigenspaces (`eigenspace_layout`, computed once per graph on
the host), the projectors P = V V^T of each eigenspace stacked into one
float32 [num_spaces, n, n] array per multiplicity
(`projectors_by_multiplicity`), each stack the batched input of one IGN
encoder; and the share of eigenvectors in eigenspaces of multiplicity > 1
(`prop_higher_mult`).  numpy only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


def round_eigvals(vals: np.ndarray, decimals: int = 5) -> np.ndarray:
    """round(x * 10^d) / 10^d, the reference's `around`."""
    scale = 10.0 ** decimals
    return np.round(vals * scale) / scale


@dataclass
class EigenspaceLayout:
    """Host-computed layout of a spectrum's eigenspaces."""
    uniq_vals: np.ndarray          # [S] one eigenvalue per space
    counts: np.ndarray             # [S] multiplicity of each space
    sections: np.ndarray           # [S] cumulative end index of each space
    uniq_mults: List[int]          # sorted unique multiplicities
    spaces_per_mult: Dict[int, int]

    @property
    def num_spaces(self) -> int:
        return len(self.counts)


def eigenspace_layout(vals: np.ndarray, decimals: int = 5
                      ) -> EigenspaceLayout:
    rounded = round_eigvals(np.asarray(vals), decimals)
    uniq_vals, counts = np.unique(rounded, return_counts=True)
    sections = np.cumsum(counts)
    uniq_mults = sorted(set(int(c) for c in counts))
    spaces_per_mult = {m: int((counts == m).sum()) for m in uniq_mults}
    return EigenspaceLayout(uniq_vals, counts, sections, uniq_mults,
                            spaces_per_mult)


def projectors_by_multiplicity(vecs: np.ndarray, layout: EigenspaceLayout
                               ) -> Dict[int, np.ndarray]:
    """{multiplicity: [spaces of that multiplicity, n, n]} float32 stacks
    of P_s = V_s V_s^T, V_s the eigenvectors of eigenspace s."""
    spaces = np.split(vecs, layout.sections[:-1], axis=1)
    buckets: Dict[int, List[np.ndarray]] = {m: [] for m in layout.uniq_mults}
    for s, vs in enumerate(spaces):
        buckets[int(layout.counts[s])].append((vs @ vs.T).astype(np.float32))
    return {m: np.stack(ps, axis=0) for m, ps in buckets.items() if ps}


def prop_higher_mult(layout: EigenspaceLayout, n: int) -> float:
    """Share of the eigenvectors in eigenspaces of multiplicity > 1."""
    c = layout.counts
    return float(c[c > 1].sum()) / float(n)
