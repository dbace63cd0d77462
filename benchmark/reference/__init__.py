"""The plain reference: AC-3 decode and encode in NumPy and eager PyTorch.

A frozen copy of the port's plain versions of the parser, the order-exact
float filterbank, the downmix and the encoder, kept here so that no later
change to the program moves the yardstick.  It imports nothing of the
program, of ``jax`` or of the JAX package.
"""
