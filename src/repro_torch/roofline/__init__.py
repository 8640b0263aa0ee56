"""Analytic roofline of a dry-run cell on the H100 (counterparts of
``repro.roofline``'s ``flops`` and ``analysis``)."""

from repro_torch.roofline.analysis import HBM_BW, LINK_BW, PEAK_FLOPS, RooflineTerms
from repro_torch.roofline.flops import CellCounts, count_cell

__all__ = ["RooflineTerms", "count_cell", "CellCounts", "PEAK_FLOPS", "HBM_BW", "LINK_BW"]
