"""Launchers and the federated mesh (port of ``repro/launch``): ``launch.mesh``
builds meshes over the ranks of a process group (client axes and a model
axis) and starts them; ``python -m repro_torch.launch.train`` runs FedVeca
rounds, sharded over the client axis with ``--mesh data=K`` or over
``--data-axis D --model-axis M``."""
