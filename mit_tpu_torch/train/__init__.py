"""Training-side modules; this port has checkpoint loading so far."""
