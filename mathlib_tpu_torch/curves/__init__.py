"""Curve parameter specs: the port's own copy of the reference's."""
