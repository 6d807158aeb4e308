"""The LLM scaffold's models: dense, MoE, hybrid and VLM decoders
(``transformer.Decoder``), RWKV6 (``rwkv6.RWKV6``) and the encoder-decoder
(``encdec.EncDec``), each an ``nn.Module`` whose parameters follow the
reference's spec (``params``); ``registry`` resolves an architecture name,
``convert`` carries weights to and from the reference's nested dicts;
``tensor_parallel`` lays a decoder out over a mesh's ``model`` axis."""
