"""The plain float64 reference that decides ``correct``.

It imports neither JAX, nor the JAX package, nor anything of the port. It
takes the generator's triplets and vectors, never anything the port made.
"""
