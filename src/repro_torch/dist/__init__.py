"""repro_torch.dist: the reference's fault module (`repro/dist/fault.py`):
deterministic fault injection and straggler detection for the scheduler's
round loop and the train loop, and checkpoint-restart training
(`ResilientTrainer`). The sharding and gradient-compression modules wait
for ROADMAP Queue A item 12."""
