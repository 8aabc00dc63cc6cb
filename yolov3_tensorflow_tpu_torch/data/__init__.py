"""Data: annotations, augmentation, label encoding, the threaded loader and
the synthetic dataset (copies of the JAX package's host modules), and the
device-resident data path (`device_augment`, `device_encode`)."""
