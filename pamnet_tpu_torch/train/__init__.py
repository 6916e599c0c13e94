"""Training of the port: schedules, EMA, optimizer, steps and epochs."""
