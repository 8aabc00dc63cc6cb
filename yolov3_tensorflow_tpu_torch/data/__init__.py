"""Host-side data helpers (the inference subset of the JAX package's
`data`)."""
