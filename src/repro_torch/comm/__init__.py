"""repro_torch.comm: lane packing, the codecs and their kernels.

  * :mod:`repro_torch.comm.bits`    - lane packing math (2/3/4/6/8/16-bit)
  * :mod:`repro_torch.comm.kernels` - the Hopper kernels of the codecs
  * :mod:`repro_torch.comm.codec`   - the codec registry and WireBuffer
  * :mod:`repro_torch.comm.matmul`  - dequant-matmul (code-resident serving)
"""
from repro_torch.comm.bits import (  # noqa: F401
    SUPPORTED_BITS,
    pack_flat,
    pack_lanes,
    pack_rows,
    packed_nbytes,
    pad_rows,
    payload_nbytes,
    unpack_flat,
    unpack_lanes,
    unpack_rows,
)
from repro_torch.comm.codec import (  # noqa: F401
    BACKENDS,
    CODEC_NAMES,
    BlockwiseCodec,
    Codec,
    IdentityCodec,
    LogCodec,
    TernaryCodec,
    UniformCodec,
    WireBuffer,
    decode_rows,
    encode_rows,
    encode_rows_ef,
    get_codec,
    resolve_backend,
    uniform_wire_codec,
)
from repro_torch.comm.matmul import dequant_matmul  # noqa: F401
