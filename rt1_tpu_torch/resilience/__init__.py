"""Deterministic fault injection (`faults`): the port's copy of
`rt1_tpu/resilience/faults.py`, armed by `RT1_FAULTS`."""
