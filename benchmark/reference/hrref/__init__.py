"""The plain reference of the benchmark: a frozen copy of the
port's plain PyTorch path (configuration, types,
scene generator, passes, the plain BVH walk, stencils and DDGI sampler,
the path tracer), without its kernels and its multi-device and
dynamic-scene paths, with a binned-SAH tree of its own and a
brute-force tracer (``ops/brute.py``). It imports nothing of the program
and is not changed when the program is."""
