"""The benchmark's plain reference: the models, the Hilbert bases, the MNIW
algebra, the online APF step and the conditional SMC step written out in
plain PyTorch and NumPy from their equations.

It imports torch and numpy only: nothing of the measured package and
nothing of the JAX package. It is computed in float64 to judge the
program; :class:`~portbench.reference.mniw.Arith` with ``tf32=True``
computes it in float32 with every matrix product's operands rounded to
TF32, the control that a judged number has to reject.
"""
