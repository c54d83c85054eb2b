"""repro_torch.dist: the serving half of the reference's fault module
(`repro/dist/fault.py`): deterministic fault injection and straggler
detection for the scheduler's round loop. Checkpoint-restart training
(`ResilientTrainer`) waits for training (ROADMAP Queue A item 11); the
sharding and gradient-compression modules for item 12."""
