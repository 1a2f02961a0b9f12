"""The CTC acoustic encoder (torch port of ``kaldi_decoder_tpu.models``)."""

from kaldi_decoder_tpu_torch.models.ctc import CtcEncoder, CtcEncoderConfig, encoder_from_numpy

__all__ = ["CtcEncoder", "CtcEncoderConfig", "encoder_from_numpy"]
