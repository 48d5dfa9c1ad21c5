"""Serving: a reconstruction engine built once per geometry and a local
HTTP front end.

Port of inverseproblemwithdiffusionmodel_tpu/serving (the 2-D engine and
its server; the cine engine is not ported yet, ROADMAP: Slice C). A
`ReconstructionEngine` holds the score net (and a seg net for guided
reconstruction) on its device and answers every request at its fixed
geometry; `serving.server` exposes it over HTTP
(`scripts/serve_recon.py`).
"""
from .engine import EngineSpec, ReconResult, ReconstructionEngine

__all__ = ["EngineSpec", "ReconResult", "ReconstructionEngine"]
