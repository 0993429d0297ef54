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

`FlowFormerPretrain` is the MAE pretraining model (stitchax
flowformer.py:903): the same encoders with the inner cost maps masked
(`random_masking`, `CostPerceiverEncoder.pretrain`) and
`MemoryDecoderPretrain`, which regresses the outer cost map's 15x15 window
at random query points (K3 at r = 7 and r = 4).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flow import convex_upsample_flow_b
from ..ops.grid import coords_grid
from ..ops.kernels.cost_lookup import cost_lookup
from ..utils.tracing import span
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
    # MAE pretraining (FlowFormerPretrain): the share of cost-map patches
    # masked, the target window (gt_r x gt_r of the outer cost map), the
    # queries a step, query centers kept gt_r // 2 from the border, and
    # the inner crop's offsets (stitchax flowformer.py:56-63)
    mask_ratio: float = 0.5
    gt_r: int = 15
    query_num: int = 30
    no_border: bool = True
    H_offset: int = 0
    W_offset: int = 0


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

    def forward(self, cost_maps, masks=None):  # (B*, H2, W2, heads)
        x, _ = pad_to_multiple(cost_maps, self.p)
        for i in range(3):
            if masks is not None:       # MAE: masked tokens zeroed first
                x = x * (1.0 - masks[i])
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

    def forward(self, latent, tgt, ids_keep=None):  # (1, K, D), (B*, N, Dt)
        if ids_keep is not None:        # MAE: the kept patches only
            tgt = torch.gather(tgt, 1, ids_keep[..., None].expand(
                -1, -1, tgt.shape[-1]))
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


def random_masking(noise: torch.Tensor, H2: int, W2: int, patch_size: int,
                   mask_ratio: float):
    """MAE cost-map masking (stitchax flowformer.py:188): noise (B, L)
    scores, L the patches of the patch-padded (H2, W2) map; the
    int(L * (1 - mask_ratio)) lowest scores are kept (a stable sort, as
    jnp.argsort). Returns (ids_keep (B, len_keep), mask (B, L), [masks at
    1, 1/2 and 1/4 of the padded map, (B, h, w, 1)]), 1 = masked."""
    Hp = H2 + (-H2) % patch_size
    Wp = W2 + (-W2) % patch_size
    hd, wd = Hp // 8, Wp // 8
    L = hd * wd
    if noise.shape[-1] != L:
        raise ValueError(f"random_masking: noise {tuple(noise.shape)} for "
                         f"{L} patches")
    len_keep = int(L * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    mask = torch.ones_like(noise)
    mask[:, :len_keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    m = mask.reshape(-1, hd, wd)
    ups = [m.repeat_interleave(f, 1).repeat_interleave(f, 2)[..., None]
           for f in (8, 4, 2)]
    return ids_shuffle[:, :len_keep], mask, ups


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
        B, H1, W1, H2, W2, heads = cost_maps.shape
        return self._encode(cost_maps.reshape(B * H1 * W1, H2, W2, heads),
                            context, B, H1, W1)

    def pretrain(self, cost_volume_inner, context, noise):
        """The MAE forward (stitchax flowformer.py:281): the inner cost maps
        masked before the patch embedding, the latents cross-attending to
        the kept patches only. noise (B*H1*W1, L)."""
        c = self.cfg
        B, H1, W1, H2, W2, heads = cost_volume_inner.shape
        ids_keep, _, masks = random_masking(noise, H2, W2, c.patch_size,
                                            c.mask_ratio)
        return self._encode(
            cost_volume_inner.reshape(B * H1 * W1, H2, W2, heads), context,
            B, H1, W1, ids_keep=ids_keep, masks=masks)

    def _encode(self, cm, context, B, H1, W1, ids_keep=None, masks=None):
        c = self.cfg
        K, D = c.cost_latent_token_num, c.cost_latent_dim
        cost_patches, _ = self.patch_embed(cm, masks)
        x = self.input_layer(self.latent_tokens, cost_patches, ids_keep)
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

    def pretrain(self, img1, img2, img1_inner, img2_inner, context, noise):
        """The MAE forward (stitchax flowformer.py:329): the outer volume
        correlates the inner img1 features with the full img2's, the inner
        volume the two inner images' features, and the perceiver embeds
        the masked inner volume. Returns (memory, outer, inner)."""
        feat_t, _ = self.feat_encoder(img2)
        feat_s_inner, _ = self.feat_encoder(img1_inner)
        feat_t_inner, _ = self.feat_encoder(img2_inner)
        cv_outer = self.cost_volume(feat_s_inner, feat_t).contiguous()
        cv_inner = self.cost_volume(feat_s_inner, feat_t_inner).contiguous()
        x = self.cost_perceiver.pretrain(cv_inner, context, noise)
        return x, cv_outer, cv_inner

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
        with span("flow.motion_encoder"):
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


class _PretrainQueryBlock(nn.Module):
    """Query encoding + cross-attention of one pretrain query, with
    `DecoderIteration`'s parameter names, so that one checkpoint loads into
    both models."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        Dq = cfg.query_latent_dim
        win2 = (2 * cfg.lookup_radius + 1) ** 2 * cfg.cost_heads_num
        self.flow_token_enc1 = Conv(win2, Dq, 1)
        self.flow_token_enc2 = Conv(Dq, Dq, 1)
        self.decoder_layer = DecoderCrossAttention(cfg)

    def forward(self, cost_forward, key, value, query_coord):
        B, H1, W1, _ = cost_forward.shape
        Dq = self.flow_token_enc2.out_channels
        q = self.flow_token_enc2(F.gelu(self.flow_token_enc1(cost_forward)))
        coord_enc = linear_position_embedding_sine(
            query_coord.reshape(B * H1 * W1, 1, 2), dim=Dq)
        out = self.decoder_layer(q.reshape(B * H1 * W1, 1, Dq), key, value,
                                 coord_enc)
        return out.reshape(B, H1, W1, Dq)


class MemoryDecoderPretrain(nn.Module):
    """The MAE pretrain decoder (stitchax flowformer.py:848): each of the
    `query_num` random query points probes the latent memory through the
    inner map's (2 lookup_radius + 1)^2 window (K3, r = 4), and a 1x1 conv
    head regresses the outer map's gt_r x gt_r window there (K3, r = 7),
    normalized per pixel with the unbiased variance; the loss is the
    per-query MSE summed over the queries. The cost maps and the query
    coordinates carry no gradient (stitchax's stop_gradient)."""

    def __init__(self, cfg: FlowFormerConfig):
        super().__init__()
        self.cfg = cfg
        Dq = cfg.query_latent_dim
        self.memory_k = nn.Linear(cfg.cost_latent_dim, Dq)
        self.memory_v = nn.Linear(cfg.cost_latent_dim, Dq)
        self.iteration = _PretrainQueryBlock(cfg)
        self.pretrain_head0 = Conv(Dq, Dq * 2, 1)
        self.pretrain_head1 = Conv(Dq * 2, Dq * 2, 1)
        self.pretrain_head2 = Conv(Dq * 2, cfg.gt_r ** 2, 1)

    def forward(self, cost_memory, cost_maps_outer, cost_maps_inner,
                query_noise):
        """query_noise (Q, B, H1, W1, 2): uniforms in [0, 1), one draw of
        query coordinates per query."""
        c = self.cfg
        B, H1, W1, H2o, W2o, _ = cost_maps_outer.shape
        radius = (c.gt_r - 1) // 2
        cost_maps_outer = cost_maps_outer.detach()
        cost_maps_inner = cost_maps_inner.detach()
        key = self.memory_k(cost_memory)
        value = self.memory_v(cost_memory)
        offs = torch.tensor([c.W_offset // 8, c.H_offset // 8],
                            dtype=torch.float32, device=query_noise.device)
        loss = 0.0
        for raw in query_noise.unbind(0):
            if c.no_border:
                co = torch.stack([raw[..., 0] * (W2o - c.gt_r),
                                  raw[..., 1] * (H2o - c.gt_r)], -1) + radius
            else:
                co = torch.stack([raw[..., 0] * W2o, raw[..., 1] * H2o], -1)
            co = co.detach()
            ci = co - offs
            tgt = encode_flow_token(cost_maps_outer, co, r=radius)
            mean = tgt.mean(-1, keepdim=True)
            var = tgt.var(-1, keepdim=True, correction=1)
            tgt = (tgt - mean) / (var + 1e-6) ** 0.5
            cost_forward = encode_flow_token(cost_maps_inner, ci,
                                             r=c.lookup_radius)
            cost_global = self.iteration(cost_forward, key, value, ci)
            pred = self.pretrain_head2(F.gelu(self.pretrain_head1(
                F.gelu(self.pretrain_head0(cost_global)))))
            loss = loss + torch.mean((pred - tgt) ** 2)
        return loss


class FlowFormerPretrain(nn.Module):
    """The MAE pretraining model (stitchax flowformer.py:903): FlowFormer's
    encoders with the pretrain decoder; its parameters are FlowFormer's
    (the same names) minus the recurrent decoder's, plus the pretrain
    head. forward(image1, image2 NHWC [0, 255], noise (B*H1*W1, L),
    query_noise (Q, B, H1, W1, 2)) -> the scalar loss."""

    def __init__(self, cfg: FlowFormerConfig = FlowFormerConfig()):
        super().__init__()
        self.cfg = cfg
        self.context_encoder = TwinsSVT()
        self.memory_encoder = MemoryEncoder(cfg)
        self.memory_decoder = MemoryDecoderPretrain(cfg)

    def forward(self, image1, image2, noise, query_noise):
        c = self.cfg
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        # each axis cropped on its own, so that one zero offset does not
        # empty the other axis (stitchax flowformer.py:921-923)
        H, W = image1.shape[1], image1.shape[2]
        sl = (slice(None), slice(c.H_offset, H - c.H_offset),
              slice(c.W_offset, W - c.W_offset))
        image1_inner, image2_inner = image1[sl], image2[sl]
        context, _ = self.context_encoder(image1_inner)
        x, cv_outer, cv_inner = self.memory_encoder.pretrain(
            image1, image2, image1_inner, image2_inner, context, noise)
        return self.memory_decoder(x, cv_outer, cv_inner, query_noise)


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
