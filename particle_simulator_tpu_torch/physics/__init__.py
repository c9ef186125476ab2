"""Physics: the plain PyTorch versions of the force law and the bucket grid."""
