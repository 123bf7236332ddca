"""The sample-batch column keys of the JAX package's
``rllib/sample_batch.py``, which the on-device path uses. ``SampleBatch``
and ``compute_gae`` come with the actor-based path."""

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
LOGPS = "action_logp"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
