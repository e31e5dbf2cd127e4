"""See the package docstring; module names follow ``theanompi_tpu``.

``MODEL_ZOO`` lists every ported model under its JAX key, as
``theanompi_tpu.models.MODEL_ZOO`` does: (module path, class name), for
``-m``/``-c`` of the launcher.  The port's transformer runs pure data
parallel only (no TP/PP/MoE entries).
"""

MODEL_ZOO = {
    "cifar10": ("theanompi_tpu_torch.models.cifar10", "Cifar10_model"),
    "alexnet": ("theanompi_tpu_torch.models.alex_net", "AlexNet"),
    "googlenet": ("theanompi_tpu_torch.models.googlenet", "GoogLeNet"),
    "vgg16": ("theanompi_tpu_torch.models.vgg16", "VGG16"),
    "resnet50": ("theanompi_tpu_torch.models.resnet50", "ResNet50"),
    "transformer_lm": ("theanompi_tpu_torch.models.transformer",
                       "TransformerLM"),
    "vgg19": ("theanompi_tpu_torch.models.model_zoo", "VGG19"),
    "resnet101": ("theanompi_tpu_torch.models.model_zoo", "ResNet101"),
    "resnet152": ("theanompi_tpu_torch.models.model_zoo", "ResNet152"),
    "resnet50_large": ("theanompi_tpu_torch.models.model_zoo",
                       "ResNet50_LargeBatch"),
    "wgan": ("theanompi_tpu_torch.models.wasserstein_gan",
             "Wasserstein_GAN"),
}

__all__ = ["MODEL_ZOO"]
