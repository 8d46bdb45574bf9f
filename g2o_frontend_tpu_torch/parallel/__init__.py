"""Distributed solvers on a mesh of shards (counterpart of ``g2o_frontend_tpu/parallel/``)."""
