"""Training (stage II so far): losses, schedules, optimizer, EMA, trainers."""
