"""Analysis: what the port has of ``chainermn_tpu/analysis/``.

Only :mod:`.protocol`, the exhaustive-interleaving model checker of the
fleet's protocols, which the runtime conformance monitor
(``observability/conform.py``) replays journals through.  The rest of the
JAX package's analyzer (the AST and jaxpr engines, shard-flow, the
schedule IR, calibration) is ROADMAP.md's A13.  Importing this package
imports nothing else.
"""
