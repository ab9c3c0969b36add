from multike_tpu_torch.data.kg import KG, KGs, read_kgs_from_folder  # noqa: F401
