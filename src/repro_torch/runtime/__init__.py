"""Admission guard, typed faults and session health."""
