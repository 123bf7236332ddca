"""Reinforcement learning of the port (counterparts of the JAX package's
``rllib``): so far the on-device PPO path (``ondevice.py``) and what it
runs, the policy networks, ``ppo_loss`` and the sample-batch keys."""
