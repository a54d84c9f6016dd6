"""Drivers: the code that drives one kind of the port's entry points for a
cell.  ``workloads/<cell>.json`` names one by its module's name."""
