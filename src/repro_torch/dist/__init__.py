"""repro_torch.dist: the distribution layer.

  sharding          the mesh context (`use_mesh` / `active_ctx`), the
                    divisibility-aware sharding rules, param / optimizer /
                    data spec trees (CompressedTensor-aware), DTensor
                    placement (`shard_params`) and activation constraints,
                    exact identities with no active mesh.
  grad_compression  the error-feedback quantized gradient all-reduce over a
                    mesh (any KV-capable codec; int8 and bf8 canonically).
  fault             deterministic fault injection, straggler detection and
                    checkpoint-restart training (`ResilientTrainer`).

Counterparts of `repro/dist/`. `sharding` also holds the sharded serving
step's layout (`local_tree`, `expert_range`, `channels`, `constrain_local`, the
collectives over a named axis), which `GenerationEngine(mesh=)` and the
layers use; what a mesh engine does not serve yet is ROADMAP Queue A
item 12's open part."""
