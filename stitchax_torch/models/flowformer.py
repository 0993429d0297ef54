"""FlowFormer++ (PerCostFormer3) optical flow.

Port of stitchax/models/flowformer.py: twins context/feature encoders ->
all-pairs cost volume -> CostPerceiverEncoder (K latent tokens per source
pixel; its vertical layers are twins blocks or, with
`vertical_encoder_attn="NA"`, `na_layer`'s neighborhood attention) ->
MemoryDecoder, a Python loop of `decoder_depth` recurrent
iterations whose local cost lookup is the CUDA kernel K3
(`ops.kernels.cost_lookup`). Inference convex-upsamples only the final
flow (`upsample_all=False`, as stitchax's Stitcher builds it); training
(`upsample_all=True`, stitchax's default) upsamples every iteration's
prediction for the sequence loss. Inputs NHWC in [0, 255].
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flow import convex_upsample_flow_b
from ..ops.grid import coords_grid
from ..ops.kernels.cost_lookup import cost_lookup
from .layers import (Conv, TokenFfn, linear_position_embedding_sine,
                     multi_head_attention, pad_to_multiple)
from .na_layer import NeighborhoodSelfAttentionLayer
from .twins import TwinsBlockRPEContext, TwinsSVT


@dataclass(frozen=True)
class FlowFormerConfig:
    """Shipped percostformer3 hyperparameters (configs/last_config.py)."""
    cost_heads_num: int = 1
    cost_latent_input_dim: int = 64
    cost_latent_token_num: int = 8
    cost_latent_dim: int = 128
    encoder_latent_dim: int = 256
    query_latent_dim: int = 64
    encoder_depth: int = 3
    decoder_depth: int = 12
    patch_size: int = 8
    vert_c_dim: int = 64
    cost_encoder_res: bool = True
    lookup_radius: int = 4
    # the cost encoder's vertical layers: twins blocks, or "NA" for the
    # neighborhood-attention variant (models/na_layer.py)
    vertical_encoder_attn: str = "twins"
    # all `decoder_depth` predictions convex-upsampled, the mask head
    # batched over the depth (stitchax's default, which its trainer uses);
    # False upsamples only the last, as stitchax's Stitcher configures it
    upsample_all: bool = False


class CostMapPatchEmbed(nn.Module):
    """Three 6x6/stride-2 convs per cost map, a sine embedding of the patch
    centers, two 1x1 ffn convs and a LayerNorm."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        dim = cfg.cost_latent_input_dim
        self.p = cfg.patch_size
        chans = [cfg.cost_heads_num, dim // 4, dim // 2, dim]
        for i in range(3):
            setattr(self, f"proj{i}", Conv(chans[i], chans[i + 1], 6,
                                           stride=2, padding=2))
        self.ffn1 = Conv(dim + 64, dim + 64, 1)
        self.ffn2 = Conv(dim + 64, dim + 64, 1)
        self.norm = nn.LayerNorm(dim + 64, eps=1e-5)

    def forward(self, cost_maps):  # (B*, H2, W2, heads)
        x, _ = pad_to_multiple(cost_maps, self.p)
        for i in range(3):
            x = getattr(self, f"proj{i}")(x)
            if i < 2:
                x = F.relu(x)
        Bs, H3, W3, C = x.shape
        grid = (coords_grid(H3, W3, device=x.device, dtype=x.dtype) * self.p
                + self.p / 2)
        enc = linear_position_embedding_sine(grid, dim=64)
        x = torch.cat([x, enc[None].expand(Bs, H3, W3, 64)], -1)
        x = self.ffn2(F.relu(self.ffn1(x)))
        return self.norm(x.reshape(Bs, H3 * W3, C + 64)), (H3, W3)


class LatentCrossAttention(nn.Module):
    """Latent tokens cross-attend to the cost patches (cross_attn='all')."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        D, Dt = cfg.cost_latent_dim, cfg.cost_latent_input_dim + 64
        self.norm1 = nn.LayerNorm(D, eps=1e-5)
        self.q = nn.Linear(D, D)
        self.k = nn.Linear(Dt, D)
        self.v = nn.Linear(Dt, D)
        self.proj = nn.Linear(D, D)
        self.norm2 = nn.LayerNorm(D, eps=1e-5)
        self.ffn = TokenFfn(D)

    def forward(self, latent, tgt):  # (1, K, D), (B*, N, Dt)
        q = self.q(self.norm1(latent)).expand(tgt.shape[0], -1, -1)
        x = multi_head_attention(q, self.k(tgt), self.v(tgt), heads=8)
        x = latent + self.proj(x)
        return x + self.ffn(self.norm2(x))


class LatentSelfAttention(nn.Module):
    """Self-attention over each source pixel's K latent tokens."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        D = cfg.cost_latent_dim
        self.norm1 = nn.LayerNorm(D, eps=1e-5)
        self.q = nn.Linear(D, D)
        self.k = nn.Linear(D, D)
        self.v = nn.Linear(D, D)
        self.proj = nn.Linear(D, D)
        self.norm2 = nn.LayerNorm(D, eps=1e-5)
        self.ffn = TokenFfn(D)

    def forward(self, x):
        y = self.norm1(x)
        y = multi_head_attention(self.q(y), self.k(y), self.v(y), heads=8)
        x = x + self.proj(y)
        return x + self.ffn(self.norm2(x))


class VerticalSelfAttention(nn.Module):
    """Attention across the source-pixel grid per latent slot: twins local
    (ws 7) then global (sr 4, K1) RPE-context blocks."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        D = cfg.cost_latent_dim
        self.local_block = TwinsBlockRPEContext(D, 8, ws=7, sr_ratio=4,
                                                vert_c_dim=cfg.vert_c_dim)
        self.global_block = TwinsBlockRPEContext(D, 8, ws=1, sr_ratio=4,
                                                 vert_c_dim=cfg.vert_c_dim)

    def forward(self, x, context):
        return self.global_block(self.local_block(x, context), context)


class CostPerceiverEncoder(nn.Module):
    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = CostMapPatchEmbed(cfg)
        self.input_layer = LatentCrossAttention(cfg)
        self.latent_tokens = nn.Parameter(
            torch.randn(1, cfg.cost_latent_token_num, cfg.cost_latent_dim))
        for i in range(cfg.encoder_depth):
            setattr(self, f"encoder_layer{i}", LatentSelfAttention(cfg))
            if cfg.vertical_encoder_attn == "NA":
                vertical = NeighborhoodSelfAttentionLayer(
                    cfg.cost_latent_dim, cfg.vert_c_dim,
                    cfg.encoder_latent_dim)
            else:
                vertical = VerticalSelfAttention(cfg)
            setattr(self, f"vertical_layer{i}", vertical)

    def forward(self, cost_maps, context):
        # cost_maps (B, H1, W1, H2, W2, heads); context (B, H1, W1, 256)
        c = self.cfg
        B, H1, W1, H2, W2, heads = cost_maps.shape
        K, D = c.cost_latent_token_num, c.cost_latent_dim
        cost_patches, _ = self.patch_embed(
            cost_maps.reshape(B * H1 * W1, H2, W2, heads))
        x = self.input_layer(self.latent_tokens, cost_patches)
        short_cut = x
        for i in range(c.encoder_depth):
            x = getattr(self, f"encoder_layer{i}")(x)
            x = x.reshape(B, H1 * W1, K, D).transpose(1, 2)
            x = x.reshape(B * K, H1, W1, D)
            x = getattr(self, f"vertical_layer{i}")(x, context)
            x = x.reshape(B, K, H1 * W1, D).transpose(1, 2)
            x = x.reshape(B * H1 * W1, K, D)
        if c.cost_encoder_res:
            x = x + short_cut
        return x


class MemoryEncoder(nn.Module):
    """Twins features on both images -> all-pairs cost volume -> perceiver.
    `bidirectional` reuses the features and takes the backward volume as
    the transpose of the forward one."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        self.cfg = cfg
        self.feat_encoder = TwinsSVT()
        self.cost_perceiver = CostPerceiverEncoder(cfg)

    def cost_volume(self, feat_s, feat_t):
        B, H1, W1, C = feat_s.shape
        heads = self.cfg.cost_heads_num
        d = C // heads
        fs = feat_s.reshape(B, H1 * W1, heads, d).transpose(1, 2)
        ft = feat_t.reshape(B, H1 * W1, heads, d).transpose(1, 2)
        corr = fs @ ft.transpose(-1, -2)        # (B, heads, HW, HW)
        return corr.reshape(B, heads, H1, W1, H1, W1).permute(0, 2, 3, 4, 5, 1)

    def forward(self, img1, img2, context):
        feat_s, _ = self.feat_encoder(img1)
        feat_t, _ = self.feat_encoder(img2)
        cost = self.cost_volume(feat_s, feat_t).contiguous()
        return self.cost_perceiver(cost, context), cost

    def bidirectional(self, img1, img2, ctx1, ctx2):
        """Both directions through ONE batched perceiver call; returns
        (memory, cost maps, context) stacked [forward; backward]."""
        feat_s, _ = self.feat_encoder(img1)
        feat_t, _ = self.feat_encoder(img2)
        cost_fwd = self.cost_volume(feat_s, feat_t)
        cost_bwd = cost_fwd.permute(0, 3, 4, 1, 2, 5)
        cost = torch.cat([cost_fwd, cost_bwd], 0).contiguous()
        ctx = torch.cat([ctx1, ctx2], 0)
        return self.cost_perceiver(cost, ctx), cost, ctx


class GmaAttention(nn.Module):
    """Single-head self-similarity attention over the context features,
    materialized once per forward and reused by every iteration."""

    def __init__(self, dim: int = 128, dim_head: int = 128):
        super().__init__()
        self.dim_head = dim_head
        self.to_qk = Conv(dim, dim_head * 2, 1, bias=False)

    def forward(self, fmap):
        B, H, W, _ = fmap.shape
        q, k = self.to_qk(fmap).split(self.dim_head, -1)
        q = (q * self.dim_head ** -0.5).reshape(B, H * W, self.dim_head)
        k = k.reshape(B, H * W, self.dim_head)
        s = q.float() @ k.float().transpose(1, 2)   # fp32 logits
        return torch.softmax(s, dim=-1).to(fmap.dtype)


class GmaAggregate(nn.Module):
    def __init__(self, dim: int = 128, dim_head: int = 128):
        super().__init__()
        self.to_v = Conv(dim, dim_head, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, attn, fmap):
        B, H, W, C = fmap.shape
        v = self.to_v(fmap).reshape(B, H * W, -1)
        out = (attn @ v).reshape(B, H, W, -1)
        return fmap + self.gamma * out


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_dim: int):
        super().__init__()
        self.convc1 = Conv(corr_dim, 256, 1)
        self.convc2 = Conv(256, 192, 3, padding=1)
        self.convf1 = Conv(2, 128, 7, padding=3)
        self.convf2 = Conv(128, 64, 3, padding=1)
        self.conv = Conv(192 + 64, 126, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], -1)))
        return torch.cat([out, flow], -1)


class SepConvGRU(nn.Module):
    """1x5 then 5x1 separable ConvGRU over [h, x]."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 384):
        super().__init__()
        cin = hidden_dim + input_dim
        for name, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{name}",
                        Conv(cin, hidden_dim, k, padding=p))

    def forward(self, h, x):
        for name in ("1", "2"):
            hx = torch.cat([h, x], -1)
            z = torch.sigmoid(getattr(self, f"convz{name}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{name}")(hx))
            q = torch.tanh(getattr(self, f"convq{name}")(
                torch.cat([r * h, x], -1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, cin: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = Conv(cin, hidden_dim, 3, padding=1)
        self.conv2 = Conv(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class MaskHead(nn.Module):
    """Convex-upsample mask head, applied once to the final GRU state."""

    def __init__(self, cin: int = 128):
        super().__init__()
        self.mask1 = Conv(cin, 256, 3, padding=1)
        self.mask2 = Conv(256, 64 * 9, 1)

    def forward(self, net):
        return 0.25 * self.mask2(F.relu(self.mask1(net)))


class GMAUpdateBlock(nn.Module):
    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        win2 = (2 * cfg.lookup_radius + 1) ** 2 * cfg.cost_heads_num
        self.encoder = BasicMotionEncoder(cfg.query_latent_dim + win2)
        self.aggregator = GmaAggregate()
        self.gru = SepConvGRU(128, 128 + 128 + 128)
        self.flow_head = FlowHead()

    def forward(self, net, inp, corr, flow, attention):
        motion = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion)
        net = self.gru(net, torch.cat([inp, motion, motion_global], -1))
        return net, self.flow_head(net)


class DecoderCrossAttention(nn.Module):
    """Per-pixel query into the latent cost memory (flow_or_pe='and')."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        Dq = cfg.query_latent_dim
        self.norm1 = nn.LayerNorm(Dq, eps=1e-5)
        self.q = nn.Linear(Dq, Dq)
        self.proj = nn.Linear(Dq, Dq)
        self.norm2 = nn.LayerNorm(Dq, eps=1e-5)
        self.ffn = TokenFfn(Dq)

    def forward(self, query, key, value, coord_enc):
        q = self.q(self.norm1(query) + coord_enc)
        x = query + self.proj(multi_head_attention(q, key, value, heads=8))
        return x + self.ffn(self.norm2(x))


def encode_flow_token(cost_maps: torch.Tensor, coords: torch.Tensor,
                      r: int = 4) -> torch.Tensor:
    """(2r+1)^2 bilinear window of each pixel's cost map at its coords:
    cost_maps (B, H1, W1, H2, W2, 1), coords (B, H1, W1, 2) ->
    (B, H1, W1, (2r+1)^2) in coords' dtype, x-major channels (K3)."""
    B, H1, W1, H2, W2, heads = cost_maps.shape
    if heads != 1:
        raise ValueError("encode_flow_token: cost_heads_num must be 1")
    s = cost_lookup(cost_maps.reshape(B * H1 * W1, H2, W2),
                    coords.reshape(B * H1 * W1, 2), r)
    return s.to(coords.dtype).reshape(B, H1, W1, -1)


class DecoderIteration(nn.Module):
    """One recurrent refinement step (weights shared across iterations)."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        self.cfg = cfg
        Dq = cfg.query_latent_dim
        win2 = (2 * cfg.lookup_radius + 1) ** 2 * cfg.cost_heads_num
        self.flow_token_enc1 = Conv(win2, Dq, 1)
        self.flow_token_enc2 = Conv(Dq, Dq, 1)
        self.decoder_layer = DecoderCrossAttention(cfg)
        self.update_block = GMAUpdateBlock(cfg)

    def forward(self, net, coords1, inp, attention, cost_maps, key, value,
                coords0):
        c = self.cfg
        B, H1, W1, _ = coords1.shape
        Dq = c.query_latent_dim
        coords1 = coords1.detach()      # stitchax's stop_gradient (:726)
        cost_forward = encode_flow_token(cost_maps, coords1, c.lookup_radius)
        q = self.flow_token_enc2(F.gelu(self.flow_token_enc1(cost_forward)))
        query = q.reshape(B * H1 * W1, 1, Dq)
        coord_enc = linear_position_embedding_sine(
            coords1.reshape(B * H1 * W1, 1, 2), dim=Dq)
        cost_global = self.decoder_layer(query, key, value, coord_enc)
        corr = torch.cat([cost_global.reshape(B, H1, W1, Dq), cost_forward],
                         -1)
        net, delta_flow = self.update_block(net, inp, corr, coords1 - coords0,
                                            attention)
        return net, coords1 + delta_flow


class MemoryDecoder(nn.Module):
    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        self.cfg = cfg
        self.proj = Conv(256, 256, 1)
        self.att = GmaAttention()
        Dq = cfg.query_latent_dim
        self.memory_k = nn.Linear(cfg.cost_latent_dim, Dq)
        self.memory_v = nn.Linear(cfg.cost_latent_dim, Dq)
        self.iteration = DecoderIteration(cfg)
        self.mask_head = MaskHead()

    def forward(self, cost_memory, context, cost_maps, upsample_all=None):
        if upsample_all is None:
            upsample_all = self.cfg.upsample_all
        B, H1, W1, _ = context.shape
        net, inp = self.proj(context).split(128, -1)
        net, inp = torch.tanh(net), F.relu(inp)
        attention = self.att(inp)
        coords0 = coords_grid(H1, W1, device=context.device,
                              dtype=context.dtype)[None].expand(B, -1, -1, -1)
        key = self.memory_k(cost_memory)
        value = self.memory_v(cost_memory)
        coords1 = coords0
        nets, flows_lr = [], []
        for _ in range(self.cfg.decoder_depth):
            net, coords1 = self.iteration(net, coords1, inp, attention,
                                          cost_maps, key, value, coords0)
            if upsample_all:
                nets.append(net)
                flows_lr.append(coords1 - coords0)
        flow_lr = coords1 - coords0
        if not upsample_all:
            return ([convex_upsample_flow_b(flow_lr, self.mask_head(net))],
                    flow_lr)
        # one mask-head pass over all iterations, the depth folded into the
        # batch (stitchax flowformer.py:806-815)
        d = len(nets)
        flows = convex_upsample_flow_b(
            torch.cat(flows_lr, 0), self.mask_head(torch.cat(nets, 0)))
        return list(flows.reshape(d, B, *flows.shape[1:]).unbind(0)), flow_lr


class FlowFormer(nn.Module):
    """Top level: NHWC [0, 255] images -> ([upsampled flow], low-res flow)."""

    def __init__(self, cfg: FlowFormerConfig = FlowFormerConfig()):
        super().__init__()
        self.cfg = cfg
        self.context_encoder = TwinsSVT()
        self.memory_encoder = MemoryEncoder(cfg)
        self.memory_decoder = MemoryDecoder(cfg)

    def forward(self, image1, image2, upsample_all=None):
        """`upsample_all` None takes the config's; False upsamples only the
        last prediction for this call."""
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        context, _ = self.context_encoder(image1)
        memory, cost = self.memory_encoder(image1, image2, context)
        return self.memory_decoder(memory, context, cost, upsample_all)

    def bidirectional(self, image1, image2):
        """((forward preds, forward lr), (backward preds, backward lr)),
        sharing the features and the transposed cost volume."""
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        B = image1.shape[0]
        ctx_both, _ = self.context_encoder(torch.cat([image1, image2], 0))
        memory, cost, ctx = self.memory_encoder.bidirectional(
            image1, image2, ctx_both[:B], ctx_both[B:])
        preds, lr = self.memory_decoder(memory, ctx, cost)
        return ([p[:B] for p in preds], lr[:B]), ([p[B:] for p in preds],
                                                  lr[B:])
