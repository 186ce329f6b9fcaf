"""PPO (rollout, GAE, update), the metric caches and the Runner."""
