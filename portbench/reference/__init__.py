"""Plain references the benchmark holds the program to.  They import
neither ``jax`` nor the JAX package nor anything of the program, and work
out everything from the inputs the benchmark made."""
