# Launch layer of the port: the serving launcher (``python -m
# repro_torch.launch.serve``).  The reference's dry-run, train and mesh
# launchers come with the model zoo (ROADMAP Queue A item 6).
