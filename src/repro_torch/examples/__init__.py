"""The paper's §4 experiments on the port: ``quickstart`` (§4.1, train the
MLP and deploy it through SPx) and ``rl_qlearning`` (§4.2). Run each with
``python -m repro_torch.examples.<name>``."""
