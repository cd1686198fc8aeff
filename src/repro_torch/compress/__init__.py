from repro_torch.compress import polyline, quantize, transport  # noqa: F401
from repro_torch.compress.transport import Codec, get_codec  # noqa: F401
