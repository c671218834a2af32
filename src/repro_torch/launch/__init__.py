"""Launchers and the federated mesh (port of ``repro/launch``, the client
axis): ``launch.mesh`` builds meshes over the ranks of a process group and
starts them; ``python -m repro_torch.launch.train`` runs FedVeca rounds,
sharded over the client axis with ``--mesh data=K``."""
