"""repro_torch.launch: meshes (`mesh.py`: the production shapes and a
test mesh as torch DeviceMeshes) and the abstract inputs and spec trees of
every (architecture x shape x mesh) cell (`specs.py`, on the meta device)."""
