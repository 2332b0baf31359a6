"""The plain reference the benchmark judges the port by.

Plain numpy and torch, written from the reference CVO-SLAM's semantics and
frozen copies of the port's plain pieces; it imports nothing of
`cvo_slam_tpu_torch`, `cvo_slam_tpu` or JAX (benchmark/tests hold that).
`frontend` rebuilds a frame's point cloud from its PNGs, `cvo` registers
two clouds and scores a registration, `tracker` is the keyframe policy.
"""
