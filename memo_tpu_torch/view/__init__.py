from memo_tpu_torch.view.plot import bin_conservation, plot_conservation, save_conservation_plot  # noqa: F401
