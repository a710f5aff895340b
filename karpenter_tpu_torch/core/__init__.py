"""Provisioning core of the port: the solver backend gate (``make_solver``)
and the in-memory cluster state the planners read (``cluster``)."""
