"""What every cell shares: the spec's loader, the import guard, the
statistics, the trace attribution, the roofline's count and the comparison
with the reference. Nothing here belongs to one cell."""
