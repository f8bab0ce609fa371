"""Proactive-greeting HRI: the serving path (scene sensor, attention
controller, service) of the JAX package's ``hri/``."""
