"""Format helpers of the port; parsing itself is ffpic_tpu's host code."""
