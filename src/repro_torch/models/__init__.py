"""The LM substrate: layers, attention, MoE, the recurrent mixers (Mamba,
xLSTM), the transformer stack, parameter counting and the public Model API."""

from repro_torch.models.model import Model, build_model, make_input_specs  # noqa: F401
