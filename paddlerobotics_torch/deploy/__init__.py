"""Deployment: open-loop Bezier gait, state estimation, policy export,
and the real-time control loop (PyTorch port of the JAX package's
``deploy/``)."""
