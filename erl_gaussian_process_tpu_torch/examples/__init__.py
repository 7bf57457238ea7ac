"""Example scripts of the PyTorch port, counterparts of the JAX package's
``examples/*.py`` with the same command lines and printed quantities, plus
``--device`` (the card by default, ``--device cpu`` without one):

    python -m erl_gaussian_process_tpu_torch.examples.gp_regression
    python -m erl_gaussian_process_tpu_torch.examples.occupancy_mapping_2d
    python -m erl_gaussian_process_tpu_torch.examples.replica_hotel_3d [N]
    python -m erl_gaussian_process_tpu_torch.examples.deploy_serving
"""
