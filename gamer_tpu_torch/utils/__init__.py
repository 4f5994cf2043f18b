"""Host utilities: the seeded RNG, the message log and timers."""
