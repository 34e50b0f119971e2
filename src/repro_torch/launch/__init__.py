"""Entry points of the port: ``python -m repro_torch.launch.serve`` (serving),
``python -m repro_torch.launch.paper_tables`` (the paper's tables), and
``matmul_grid.MatmulGrid`` (the paper's 2-D application on the card)."""
