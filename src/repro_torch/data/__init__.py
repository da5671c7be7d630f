"""The synthetic token pipeline of the training path."""
