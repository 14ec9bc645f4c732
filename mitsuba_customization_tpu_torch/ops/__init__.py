"""Hand-written Hopper kernels (csrc/) with their plain PyTorch versions.

K1 `merl_sorted.eval_trilinear` and K2 `marginal_sorted.cond_sample_pdf`;
`build` compiles and loads the CUDA library at first use.
"""
