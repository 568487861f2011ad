"""launches_per_step.train: CUDA API calls that put work on a stream
(``tracing.HOST_LAUNCHES``) per traced training step."""


def read(layer):
    if layer is None or layer.get("kind") != "train" or not layer["steps"]:
        return None
    return layer["region"].launches / layer["steps"]
