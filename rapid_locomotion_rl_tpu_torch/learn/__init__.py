"""Policy rollout (PPO's collection half)."""
