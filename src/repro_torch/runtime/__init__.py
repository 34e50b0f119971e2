"""Serving runtime: ``ServeEngine`` (prefill, then greedy decode).
``ReplicaDispatcher`` comes later (ROADMAP queue 1, item 8: serving dispatch)."""

from .serve_loop import ServeEngine

__all__ = ["ServeEngine"]
