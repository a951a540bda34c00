"""Torus arithmetic, exact NTTs and the blind-rotation kernels."""
