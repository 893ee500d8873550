"""Pallas GPU kernels (Triton route) for the decode hot path.

The reference's hand-written WGSL shaders (th.cpp) map to:

  quant GEMV          -> qgemv.py (vs wgsl_vector_mat_mul_transpose,
                                  th.cpp:2839-2892)
  paged decode attend -> paged_attention.py (vs the row_softmax decode
                                  path, th.cpp:1865-1961)

Every other op runs as plain XLA; `ops/dispatch.py` says which shapes
take a kernel.
"""
