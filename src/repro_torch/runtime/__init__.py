"""The fault runtime: the admission guard, typed faults, session health,
the divergence watchdog, backend failover and the chaos seams."""
