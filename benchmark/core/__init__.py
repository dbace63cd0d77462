"""The harness: cell lookup, inputs from the seed, the timed window, the
trace reduction, the yardstick (peaks and least work) and the check."""
