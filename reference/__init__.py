"""Plain PyTorch references of the models the port runs, written from their
published descriptions: float32, no hand kernel, nothing imported from the
port or from JAX. The tests hold the port to them."""
