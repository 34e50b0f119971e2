"""Entry points of the port: ``python -m repro_torch.launch.serve`` (serving),
``python -m repro_torch.launch.train`` (training, DFPA-balanced groups with
``--groups``), ``python -m repro_torch.launch.paper_tables`` (the paper's
tables), ``python -m repro_torch.launch.dryrun`` (every arch x shape cell
against the card's memory and peaks, without the card), ``mesh`` (the
card's constants and the one-card mesh), and ``matmul_grid.MatmulGrid``
(the paper's 2-D application on the card)."""
