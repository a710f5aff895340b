"""Provisioning core of the port: the solver backend gate (``make_solver``)."""
