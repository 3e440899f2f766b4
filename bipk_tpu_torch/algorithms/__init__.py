"""Particle-filter building blocks of the port."""
