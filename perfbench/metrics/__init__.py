"""Metric readers: ``<metric>.py`` defines ``read(m)``, which takes the
run's ``harness.Measured`` and returns the metric's value, or None where
the run holds nothing to read it from.  The FLOP and byte functions and
the table of peaks sit beside them."""
