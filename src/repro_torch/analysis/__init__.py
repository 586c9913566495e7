"""Analysis of the dry run's traces: collective traffic and the roofline."""
