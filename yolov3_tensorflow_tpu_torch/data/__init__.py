"""Host-side data: annotations, augmentation, label encoding, the threaded
loader and the synthetic dataset (copies of the JAX package's host
modules)."""
