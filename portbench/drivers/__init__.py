"""The workload drivers, one file each, found by a traffic mix's
``"algorithm"``: see :mod:`portbench.workload`."""
