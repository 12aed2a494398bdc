"""Tensor ops of the port (channels-last, JAX package layout).

Each kernel entry (``warp_forward``, ``warp_dfeat``, ``warp_dflow``,
``correlation_forward``, ``correlation_dfirst``, ``correlation_dsecond``,
``merge_forward``, ``merge_backward``, ``affine_resample``,
``conv3x3_s2d_forward``, ``conv3x3_s2d_dweight``,
``dead_leaves_composite``) opens an
``op.<entry>`` span around its whole body, on the CPU path too
(``utils/profiling.annotate``: free with no profiler running)."""
