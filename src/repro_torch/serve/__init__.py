"""Serving: prefill, one-token decode steps and batched greedy generation
(a port of ``repro.serve``)."""
