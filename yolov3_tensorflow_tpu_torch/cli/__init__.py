"""Command-line entry points of the port (the inference subset of the JAX
package's `cli`)."""
