from .plots import (plot_data, plot_fft, plot_fft_all, plot_kernel_fit,
                    plot_parameters, plot_patches, plot_pdgp, plot_pianoroll,
                    plot_predict, plot_predict_all, plot_sources,
                    plot_sources_all, plot_trained_models, plot_training_all,
                    plot_zoom_in, plotgp)

__all__ = ["plotgp", "plot_predict", "plot_fft", "plot_pianoroll",
           "plot_sources", "plot_kernel_fit", "plot_pdgp", "plot_zoom_in",
           "plot_data", "plot_predict_all", "plot_sources_all",
           "plot_training_all", "plot_trained_models", "plot_parameters",
           "plot_patches", "plot_fft_all"]
