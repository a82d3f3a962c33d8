"""Host data pipeline of the port: copies of the JAX package's jax-free
loaders (KITTI, synthetic), batching and prefetch."""
