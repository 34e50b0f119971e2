"""Serving runtime: ``ServeEngine`` (prefill, then greedy decode).
``ReplicaDispatcher`` comes later (ROADMAP queue 1, item 5)."""

from .serve_loop import ServeEngine

__all__ = ["ServeEngine"]
