"""Cost model of the tile tasks: what the runtime's priorities and its
simulated backend read (`costmodel`)."""
