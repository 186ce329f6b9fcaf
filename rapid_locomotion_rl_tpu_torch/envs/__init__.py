"""Task environment: observations, rewards, resets, DR and the command
curriculum."""
