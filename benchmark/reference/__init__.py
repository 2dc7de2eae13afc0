"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch versions at commit d587314 (each file names its source), with no
kernel, no CUDA graph and nothing of the port, of the JAX package or of
JAX imported.  `api.solve_batch` is the staged batched solve, `node.tick`
the single-robot node's tick; both take any dtype the control asks for."""
