"""Serving: a reconstruction engine built once per geometry and a local
HTTP front end.

Port of inverseproblemwithdiffusionmodel_tpu/serving: the 2-D engine, the
2D+time (cine) engine and their server. A `ReconstructionEngine` holds the
score net (and a seg net for guided reconstruction) on its device and
answers every request at its fixed geometry; a `CineReconstructionEngine`
does the same for cine volumes with a spatial and a temporal prior;
`serving.server` exposes either over HTTP (`scripts/serve_recon.py`).
"""
from .cine import CineEngineSpec, CineReconstructionEngine
from .engine import EngineSpec, ReconResult, ReconstructionEngine

__all__ = ["CineEngineSpec", "CineReconstructionEngine", "EngineSpec",
           "ReconResult", "ReconstructionEngine"]
