"""Prompt templates: detection, application, multi-turn chat rendering.

Own copy of ``bitnet_tpu/templates/__init__.py``: the port imports nothing of the
JAX package.

Capability parity with ``bitnet-prompt-templates``
(``src/lib.rs:77-3103``): the full template-type catalog (58 types) with
auto-detection from GGUF metadata / model name / embedded jinja,
``apply`` for single prompts, ``render_chat`` for message lists,
per-template stop sequences and BOS policy.

Architecture differs from the reference deliberately: instead of one
``apply_*`` function per type (10.5k LoC there), types are rows in a
spec TABLE mapping to a small set of render FAMILIES (chatml, header,
inst, role-tag, hash-markers, role-colon, cohere, …).  Most of the
catalog is a family + token-set + default-system-prompt triple.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class TemplateType(enum.Enum):
    # -- core types (round-1 set; renders are pinned by tests) --------------
    RAW = "raw"
    INSTRUCT = "instruct"
    LLAMA3_CHAT = "llama3-chat"
    CHATML = "chatml"
    MISTRAL_INSTRUCT = "mistral-instruct"
    ALPACA = "alpaca"
    PHI3 = "phi3"
    GEMMA = "gemma"
    ZEPHYR = "zephyr"
    # -- full reference catalog (lib.rs:77-185) ------------------------------
    PHI4_CHAT = "phi4-chat"
    QWEN_CHAT = "qwen-chat"
    QWEN25_CHAT = "qwen25-chat"
    DEEPSEEK_CHAT = "deepseek-chat"
    DEEPSEEK_V3_CHAT = "deepseek-v3-chat"
    STARCODER = "starcoder"
    FALCON_CHAT = "falcon-chat"
    FALCON2_CHAT = "falcon2-chat"
    CODELLAMA_INSTRUCT = "codellama-instruct"
    COHERE_COMMAND = "cohere-command"
    COMMAND_R_PLUS = "command-r-plus"
    COHERE_AYA = "cohere-aya"
    INTERNLM_CHAT = "internlm-chat"
    YI_CHAT = "yi-chat"
    BAICHUAN_CHAT = "baichuan-chat"
    CHATGLM_CHAT = "chatglm-chat"
    MPT_INSTRUCT = "mpt-instruct"
    RWKV_WORLD = "rwkv-world"
    OLMO_INSTRUCT = "olmo-instruct"
    OLMO2_CHAT = "olmo2-chat"
    FILL_IN_MIDDLE = "fill-in-middle"
    VICUNA_CHAT = "vicuna-chat"
    ORCA_CHAT = "orca-chat"
    SOLAR_INSTRUCT = "solar-instruct"
    ALPACA_INSTRUCT = "alpaca-instruct"
    NOUS_HERMES = "nous-hermes"
    WIZARDLM = "wizardlm"
    OPENCHAT = "openchat"
    GRANITE_CHAT = "granite-chat"
    NEMOTRON_CHAT = "nemotron-chat"
    SAIGA_CHAT = "saiga-chat"
    LLAMA2_CHAT = "llama2-chat"
    LLAMA31_CHAT = "llama31-chat"
    LLAMA32_CHAT = "llama32-chat"
    GEMMA2_CHAT = "gemma2-chat"
    CODEGEMMA = "codegemma"
    TINYLLAMA_CHAT = "tinyllama-chat"
    DOLPHIN_CHAT = "dolphin-chat"
    CHATGPT_CHAT = "chatgpt-chat"
    MIXTRAL_INSTRUCT = "mixtral-instruct"
    MISTRAL_NEMO = "mistral-nemo"
    STABLELM_CHAT = "stablelm-chat"
    BLOOM_CHAT = "bloom-chat"
    JAMBA_CHAT = "jamba-chat"
    PERSIMMON_CHAT = "persimmon-chat"
    XVERSE_CHAT = "xverse-chat"
    ARCTIC_INSTRUCT = "arctic-instruct"
    DBRX_INSTRUCT = "dbrx-instruct"
    EXAONE_CHAT = "exaone-chat"
    MINICPM_CHAT = "minicpm-chat"
    SMOLLM_CHAT = "smollm-chat"
    PHI2_INSTRUCT = "phi2-instruct"

    @classmethod
    def parse(cls, s: str) -> "TemplateType":
        s = s.strip().lower().replace("_", "-")
        for t in cls:
            if t.value == s:
                return t
        aliases = {
            "qwen": cls.QWEN_CHAT, "qwen2.5": cls.QWEN25_CHAT,
            "phi4": cls.PHI4_CHAT, "phi-4": cls.PHI4_CHAT,
            "phi2": cls.PHI2_INSTRUCT, "deepseek": cls.DEEPSEEK_CHAT,
            "falcon": cls.FALCON_CHAT, "cohere": cls.COHERE_COMMAND,
            "aya": cls.COHERE_AYA, "internlm": cls.INTERNLM_CHAT,
            "yi": cls.YI_CHAT, "baichuan": cls.BAICHUAN_CHAT,
            "chatglm": cls.CHATGLM_CHAT, "glm-4": cls.CHATGLM_CHAT,
            "glm4": cls.CHATGLM_CHAT, "mpt": cls.MPT_INSTRUCT,
            "rwkv": cls.RWKV_WORLD, "olmo": cls.OLMO_INSTRUCT,
            "olmo2": cls.OLMO2_CHAT, "fim": cls.FILL_IN_MIDDLE,
            "vicuna": cls.VICUNA_CHAT, "orca": cls.ORCA_CHAT,
            "solar": cls.SOLAR_INSTRUCT, "command-r": cls.COHERE_COMMAND,
            "llama2": cls.LLAMA2_CHAT, "llama-2-chat": cls.LLAMA2_CHAT,
            "llama3.1": cls.LLAMA31_CHAT, "llama-3.1-chat": cls.LLAMA31_CHAT,
            "llama3.2": cls.LLAMA32_CHAT, "llama-3.2-chat": cls.LLAMA32_CHAT,
            "gemma2": cls.GEMMA2_CHAT, "mixtral": cls.MIXTRAL_INSTRUCT,
            "bloom": cls.BLOOM_CHAT, "jamba": cls.JAMBA_CHAT,
            "persimmon": cls.PERSIMMON_CHAT, "xverse": cls.XVERSE_CHAT,
            "arctic": cls.ARCTIC_INSTRUCT, "dbrx": cls.DBRX_INSTRUCT,
            "exaone": cls.EXAONE_CHAT, "minicpm": cls.MINICPM_CHAT,
            "smollm": cls.SMOLLM_CHAT, "smol-lm": cls.SMOLLM_CHAT,
            "code-completion": cls.STARCODER,
        }
        if s in aliases:
            return aliases[s]
        raise ValueError(
            f"unknown template {s!r}; options: {[t.value for t in cls]}"
        )


@dataclass(frozen=True)
class Message:
    role: str  # 'system' | 'user' | 'assistant'
    content: str


@dataclass(frozen=True)
class TemplateSpec:
    """Rendering rules + stop/BOS policy (lib.rs:1948-2124)."""

    type: TemplateType
    stop_sequences: tuple[str, ...] = ()
    add_bos: bool = True


# ---------------------------------------------------------------------------
# Spec table.  Each row: family, family options, stop sequences, BOS
# policy, leak markers (output validation), and name-detection keys.
# Formats are the public model-card conventions; the catalog and stop/BOS
# choices mirror the reference (lib.rs:1948-2124 default_stop_sequences /
# should_add_bos).
# ---------------------------------------------------------------------------
_CHATML_STOPS = ("<|im_end|>", "<|endoftext|>")
_CHATML_LEAKS = ("<|im_start|>", "<|im_end|>")

# family option keys:
#   chatml:  default_system
#   header:  default_system (always-injected when set — llama 3.1/3.2)
#   inst:    sys_wrap ('merge' = into first [INST]; 'sys' = <<SYS>> block),
#            default_system, trailing_space
#   roletag: end ('<|end|>\n' | '</s>\n' | '\n'), gen ('<|assistant|>\n')
#   colon:   user, asst, sys ('label'|'prefix'|'rwkv'), sep, default_system
#   hash:    sys_label, user_label, resp_label, default_system
#   cohere:  newline (bool), default_system
_DEF: dict[TemplateType, dict] = {
    TemplateType.RAW: dict(family="raw", stops=(), bos=True, leaks=()),
    TemplateType.INSTRUCT: dict(
        family="colon", user="User: ", asst="Assistant: ", sys="label",
        sep="\n", stops=("### Instruction:",), bos=True,
        leaks=("### Instruction:", "### Response:"),
        names=("instruct", "chat")),
    TemplateType.LLAMA3_CHAT: dict(
        family="header", stops=("<|eot_id|>",), bos=False,
        leaks=("<|eot_id|>", "<|start_header_id|>", "<|end_header_id|>"),
        jinja=("<|start_header_id|>", "<|eot_id|>"),
        names=("llama-3", "llama3", "bitnet")),
    TemplateType.CHATML: dict(
        family="chatml", stops=("<|im_end|>",), bos=False,
        leaks=_CHATML_LEAKS, jinja=("<|im_start|>",)),
    TemplateType.MISTRAL_INSTRUCT: dict(
        family="inst", sys_wrap="merge", stops=("[INST]",), bos=True,
        leaks=("[INST]", "[/INST]"), jinja=("[INST]",),
        names=("mistral",)),
    TemplateType.ALPACA: dict(
        family="alpaca", stops=("### Instruction:",), bos=True,
        leaks=("### Instruction:", "### Input:"), names=("alpaca",)),
    TemplateType.PHI3: dict(
        family="roletag", end="<|end|>\n", stops=("<|end|>", "<|user|>"),
        bos=False, leaks=("<|end|>", "<|user|>", "<|assistant|>"),
        names=("phi-3", "phi3")),
    TemplateType.GEMMA: dict(
        family="gemma", stops=("<end_of_turn>",), bos=False,
        leaks=("<start_of_turn>", "<end_of_turn>"),
        jinja=("<start_of_turn>",), names=("gemma",)),
    TemplateType.ZEPHYR: dict(
        family="roletag", end="</s>\n", stops=("</s>", "<|user|>"),
        bos=False, leaks=("<|user|>", "<|assistant|>"),
        names=("zephyr",)),
    # -- ChatML variants: same markers, distinct default system prompts ----
    TemplateType.PHI4_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS, names=("phi-4", "phi4")),
    TemplateType.QWEN_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS, names=("qwen",)),
    TemplateType.QWEN25_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are Qwen, created by Alibaba Cloud. "
                       "You are a helpful assistant.",
        names=("qwen2.5", "qwen-2.5", "qwen25")),
    TemplateType.DEEPSEEK_CHAT: dict(
        family="chatml", stops=("<|im_end|>", "<|end▁of▁sentence|>"),
        bos=False, leaks=_CHATML_LEAKS, names=("deepseek",)),
    TemplateType.DEEPSEEK_V3_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are DeepSeek Chat, a helpful and harmless "
                       "AI assistant.",
        names=("deepseek-v3", "deepseek_v3")),
    TemplateType.INTERNLM_CHAT: dict(
        family="chatml", stops=("<|im_end|>", "<eoa>"), bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are a helpful assistant.",
        names=("internlm",)),
    TemplateType.YI_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are a helpful assistant.", names=("yi-",)),
    TemplateType.ORCA_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are Orca, an AI language model created by "
                       "Microsoft. You are a cautious assistant. You "
                       "carefully follow instructions.",
        names=("orca",)),
    TemplateType.NOUS_HERMES: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are a helpful, honest and harmless AI "
                       "assistant.",
        names=("hermes", "nous")),
    TemplateType.SAIGA_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS, names=("saiga", "yandexgpt")),
    TemplateType.TINYLLAMA_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=True,
        leaks=_CHATML_LEAKS,
        default_system="You are a friendly chatbot who always responds "
                       "in a helpful manner.",
        names=("tinyllama",)),
    TemplateType.DOLPHIN_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are Dolphin, a helpful AI assistant.",
        names=("dolphin",)),
    TemplateType.CHATGPT_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are a helpful assistant.",
        names=("chatgpt", "gpt-4", "gpt4")),
    TemplateType.STABLELM_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are a helpful, respectful and honest "
                       "assistant.",
        names=("stablelm",)),
    TemplateType.JAMBA_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are Jamba, a helpful AI assistant made by "
                       "AI21 Labs.",
        names=("jamba",)),
    TemplateType.ARCTIC_INSTRUCT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are a helpful AI assistant.",
        names=("arctic",)),
    TemplateType.DBRX_INSTRUCT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are DBRX, created by Databricks. You are a "
                       "helpful assistant.",
        names=("dbrx",)),
    TemplateType.MINICPM_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are a helpful assistant.",
        names=("minicpm",)),
    TemplateType.SMOLLM_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS, names=("smollm",)),
    TemplateType.FALCON2_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are a helpful assistant.",
        names=("falcon2", "falcon-2")),
    TemplateType.OLMO2_CHAT: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS,
        default_system="You are OLMo 2, a helpful AI assistant.",
        names=("olmo-2", "olmo2")),
    TemplateType.COHERE_AYA: dict(
        family="chatml", stops=_CHATML_STOPS, bos=False,
        leaks=_CHATML_LEAKS, names=("aya",)),
    # -- llama-3 header family ---------------------------------------------
    TemplateType.LLAMA31_CHAT: dict(
        family="header",
        default_system="You are a helpful, harmless, and honest AI "
                       "assistant.",
        stops=("<|eot_id|>", "<|end_of_text|>"), bos=False,
        leaks=("<|eot_id|>", "<|start_header_id|>", "<|end_header_id|>"),
        names=("llama-3.1", "llama3.1")),
    TemplateType.LLAMA32_CHAT: dict(
        family="header",
        default_system="You are a helpful, harmless, and honest AI "
                       "assistant.",
        stops=("<|eot_id|>", "<|end_of_text|>"), bos=False,
        leaks=("<|eot_id|>", "<|start_header_id|>", "<|end_header_id|>"),
        names=("llama-3.2", "llama3.2")),
    # -- gemma family ---------------------------------------------------
    TemplateType.GEMMA2_CHAT: dict(
        family="gemma", stops=("<end_of_turn>", "<start_of_turn>"),
        bos=True, leaks=("<start_of_turn>", "<end_of_turn>"),
        # 'gemma-2-' (trailing dash) so 'gemma-2b' (a Gemma-1 size) does
        # not match the Gemma-2 family
        names=("gemma-2-", "gemma2-")),
    TemplateType.CODEGEMMA: dict(
        family="gemma", stops=("<end_of_turn>", "<start_of_turn>"),
        bos=False, leaks=("<start_of_turn>", "<end_of_turn>"),
        names=("codegemma",)),
    # -- [INST] family ---------------------------------------------------
    TemplateType.LLAMA2_CHAT: dict(
        family="inst", sys_wrap="sys", trailing_space=True,
        default_system="You are a helpful, respectful and honest "
                       "assistant.",
        stops=("</s>",), bos=True,
        leaks=("[INST]", "[/INST]", "<<SYS>>", "<</SYS>>"),
        names=("llama-2", "llama2")),
    TemplateType.CODELLAMA_INSTRUCT: dict(
        family="inst", sys_wrap="sys", stops=("</s>",), bos=False,
        leaks=("[INST]", "[/INST]", "<<SYS>>", "<</SYS>>"),
        names=("codellama", "code-llama")),
    TemplateType.MIXTRAL_INSTRUCT: dict(
        family="inst", sys_wrap="merge", stops=("</s>",), bos=True,
        leaks=("[INST]", "[/INST]"), names=("mixtral",)),
    TemplateType.MISTRAL_NEMO: dict(
        family="inst", sys_wrap="merge", stops=("</s>",), bos=False,
        leaks=("[INST]", "[/INST]"), names=("nemo",)),
    # -- role-tag family ---------------------------------------------------
    TemplateType.OLMO_INSTRUCT: dict(
        family="roletag", end="\n",
        stops=("<|endoftext|>", "<|user|>"), bos=False,
        leaks=("<|user|>", "<|assistant|>"), names=("olmo",)),
    # -- role-colon family -------------------------------------------------
    TemplateType.FALCON_CHAT: dict(
        family="colon", user="User: ", asst="Falcon:", sys="label",
        sep="\n", stops=("\nUser:", "<|endoftext|>"), bos=True,
        leaks=("\nUser:", "\nFalcon:"), names=("falcon",)),
    TemplateType.RWKV_WORLD: dict(
        family="colon", user="User: ", asst="Assistant:", sys="rwkv",
        sep="\n\n", stops=("\nUser:", "\n\n"), bos=True,
        leaks=("\nUser:",), names=("rwkv",)),
    TemplateType.VICUNA_CHAT: dict(
        family="colon", user="USER: ", asst="ASSISTANT:", sys="prefix",
        sep="\n",
        default_system="A chat between a curious user and an artificial "
                       "intelligence assistant. The assistant gives "
                       "helpful, detailed, and polite answers to the "
                       "user's questions.",
        stops=("USER:", "</s>"), bos=True,
        leaks=("USER:", "ASSISTANT:"), names=("vicuna",)),
    TemplateType.WIZARDLM: dict(
        family="colon", user="USER: ", asst="ASSISTANT: ", sys="prefix",
        sep="\n",
        default_system="A chat between a curious user and an artificial "
                       "intelligence assistant. The assistant gives "
                       "helpful, detailed, and polite answers to the "
                       "user's questions.",
        stops=("USER:", "</s>"), bos=True,
        leaks=("USER:", "ASSISTANT:"), names=("wizardlm", "wizard-lm")),
    TemplateType.BLOOM_CHAT: dict(
        family="colon", user="User: ", asst="Assistant: ", sys="prefix",
        sep="\n", stops=("User:", "</s>"), bos=False,
        leaks=("User:", "Assistant:"), names=("bloom",)),
    TemplateType.PERSIMMON_CHAT: dict(
        family="colon", user="human: ", asst="adept: ", sys="prefix",
        sep="\n", stops=("human:", "</s>"), bos=False,
        leaks=("human:", "adept:"), names=("persimmon",)),
    TemplateType.XVERSE_CHAT: dict(
        family="colon", user="Human: ", asst="Assistant: ", sys="prefix",
        sep="\n\n", stops=("Human:", "</s>"), bos=False,
        leaks=("Human:",), names=("xverse",)),
    TemplateType.PHI2_INSTRUCT: dict(
        family="colon", user="Instruct: ", asst="Output: ", sys="prefix",
        sep="\n", stops=("Instruct:", "</s>"), bos=True,
        leaks=("Instruct:", "Output:"), names=("phi-2", "phi2")),
    # -- hash-marker family -------------------------------------------------
    TemplateType.MPT_INSTRUCT: dict(
        family="hash", sys_label="### System\n",
        user_label="### Instruction\n", resp_label="### Response\n",
        stops=("### Instruction", "<|endoftext|>"), bos=True,
        leaks=("### Instruction", "### Response"), names=("mpt",)),
    TemplateType.SOLAR_INSTRUCT: dict(
        family="hash", sys_label="### System:\n",
        user_label="### User:\n", resp_label="### Assistant:\n",
        stops=("### User:", "</s>"), bos=True,
        leaks=("### User:", "### Assistant:"), names=("solar",)),
    TemplateType.ALPACA_INSTRUCT: dict(
        family="hash", sys_label="", user_label="### Instruction:\n",
        resp_label="### Response:\n",
        default_system="Below is an instruction that describes a task. "
                       "Write a response that appropriately completes "
                       "the request.",
        stops=("### Instruction:", "</s>"), bos=True,
        leaks=("### Instruction:", "### Response:"), names=()),
    # -- token-bracketed families -------------------------------------------
    TemplateType.COHERE_COMMAND: dict(
        family="cohere", newline=False,
        stops=("<|END_OF_TURN_TOKEN|>",), bos=False,
        leaks=("<|START_OF_TURN_TOKEN|>", "<|END_OF_TURN_TOKEN|>"),
        names=("command-r", "cohere")),
    TemplateType.COMMAND_R_PLUS: dict(
        family="cohere", newline=True,
        default_system="You are Command-R+, a large language model "
                       "trained to have polite, helpful, inclusive "
                       "conversations with people.",
        stops=("<|END_OF_TURN_TOKEN|>",), bos=True,
        leaks=("<|START_OF_TURN_TOKEN|>", "<|END_OF_TURN_TOKEN|>"),
        names=("command-r-plus", "command-r+")),
    TemplateType.BAICHUAN_CHAT: dict(
        family="baichuan", stops=("</s>",), bos=False,
        leaks=("<reserved_106>", "<reserved_107>"), names=("baichuan",)),
    TemplateType.CHATGLM_CHAT: dict(
        family="chatglm", stops=("<|user|>", "<|observation|>"),
        bos=False, leaks=("[gMASK]", "<sop>", "<|user|>"),
        names=("chatglm", "glm-4", "glm4")),
    TemplateType.GRANITE_CHAT: dict(
        family="granite",
        default_system="You are Granite, an AI language model developed "
                       "by IBM.",
        stops=("<|end_of_role|>", "<|end_of_text|>"), bos=False,
        leaks=("<|start_of_role|>", "<|end_of_role|>"),
        names=("granite",)),
    TemplateType.NEMOTRON_CHAT: dict(
        family="nemotron",
        default_system="You are a helpful, respectful and honest "
                       "assistant.",
        stops=("<extra_id_1>", "</s>"), bos=False,
        leaks=("<extra_id_0>", "<extra_id_1>"), names=("nemotron",)),
    TemplateType.EXAONE_CHAT: dict(
        family="exaone",
        default_system="You are EXAONE model from LG AI Research, a "
                       "helpful assistant.",
        stops=("[|endofturn|]",), bos=False,
        leaks=("[|system|]", "[|user|]", "[|assistant|]", "[|endofturn|]"),
        names=("exaone",)),
    TemplateType.OPENCHAT: dict(
        family="openchat", stops=("<|end_of_turn|>",), bos=True,
        leaks=("GPT4 Correct User:", "GPT4 Correct Assistant:",
               "<|end_of_turn|>"),
        names=("openchat",)),
    # -- code completion ----------------------------------------------------
    TemplateType.STARCODER: dict(
        family="starcoder", stops=("<|endoftext|>",), bos=True,
        leaks=(), names=("starcoder", "star-coder")),
    TemplateType.FILL_IN_MIDDLE: dict(
        family="fim",
        stops=("<fim_suffix>", "<|endoftext|>", "<fim_pad>"), bos=False,
        leaks=("<fim_prefix>", "<fim_suffix>", "<fim_middle>"),
        names=()),
}

SPECS: dict[TemplateType, TemplateSpec] = {
    t: TemplateSpec(t, stop_sequences=tuple(d.get("stops", ())),
                    add_bos=d.get("bos", True))
    for t, d in _DEF.items()
}


# --------------------------------------------------------------------------
# Detection (lib.rs:362: GGUF metadata → tokenizer name → jinja heuristics)
# --------------------------------------------------------------------------
# name keys checked in THIS order: branded keys longest-first (so
# "llama-3.1" wins over "llama-3", "codegemma" over "gemma"), then the
# generic fallbacks ("instruct", "chat") dead last regardless of length
# (so "falcon-7b-instruct" hits falcon, not the generic).
_GENERIC_KEYS = frozenset({"instruct", "chat"})
_NAME_ORDER: list[tuple[str, TemplateType]] = sorted(
    [(key, t) for t, d in _DEF.items() for key in d.get("names", ())],
    key=lambda kv: (kv[0] in _GENERIC_KEYS, -len(kv[0])),
)


def detect(metadata: dict | None = None, model_name: str = "") -> TemplateType:
    md = metadata or {}
    jinja = md.get("tokenizer.chat_template", "") or ""
    name = (md.get("general.name", "") or model_name or "").lower()

    if "<|start_header_id|>" in jinja or "<|eot_id|>" in jinja:
        return TemplateType.LLAMA3_CHAT
    if "<|im_start|>" in jinja:
        return TemplateType.CHATML
    if "[INST]" in jinja:
        return TemplateType.MISTRAL_INSTRUCT
    if "<start_of_turn>" in jinja:
        return TemplateType.GEMMA
    if "<|END_OF_TURN_TOKEN|>" in jinja:
        return TemplateType.COHERE_COMMAND
    if "<|start_of_role|>" in jinja:
        return TemplateType.GRANITE_CHAT
    if "[gMASK]" in jinja:
        return TemplateType.CHATGLM_CHAT
    if "<|end|>" in jinja and "<|assistant|>" in jinja:
        return TemplateType.PHI3
    if "<|assistant|>" in jinja and "</s>" in jinja:
        return TemplateType.ZEPHYR
    if "<fim_prefix>" in jinja:
        return TemplateType.FILL_IN_MIDDLE

    if "bitnet" in name and "instruct" not in name and not jinja:
        # base BitNet checkpoints (e.g. b1.58-2B-4T) ship llama3-style chat
        return TemplateType.LLAMA3_CHAT
    # match the basename before the full path: 'mistralai/Mixtral-8x7B'
    # must hit 'mixtral', not the 'mistral' inside the org prefix
    basename = name.rsplit("/", 1)[-1]
    for candidate in (basename, name):
        for key, t in _NAME_ORDER:
            # generic 'instruct'/'chat' keys run LAST (shortest), so
            # branded names win first
            if key in candidate:
                return t
    return TemplateType.RAW


# --------------------------------------------------------------------------
# Family renderers
# --------------------------------------------------------------------------
def _split_system(messages: list[Message],
                  default_system: str | None) -> tuple[str | None,
                                                       list[Message]]:
    system = None
    rest = []
    for m in messages:
        if m.role == "system" and system is None:
            system = m.content
        else:
            rest.append(m)
    if system is None:
        system = default_system
    return system, rest


def _render_chatml(d: dict, messages: list[Message], agp: bool) -> str:
    out = []
    default = d.get("default_system")
    if default is not None and not any(m.role == "system" for m in messages):
        messages = [Message("system", default)] + list(messages)
    for m in messages:
        out.append(f"<|im_start|>{m.role}\n{m.content}<|im_end|>\n")
    if agp:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _render_header(d: dict, messages: list[Message], agp: bool) -> str:
    default = d.get("default_system")
    if default is not None and not any(m.role == "system" for m in messages):
        messages = [Message("system", default)] + list(messages)
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(
            f"<|start_header_id|>{m.role}<|end_header_id|>\n\n"
            f"{m.content}<|eot_id|>"
        )
    if agp:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _render_gemma(d: dict, messages: list[Message], agp: bool) -> str:
    # gemma has no system role: a system prompt prefixes the first
    # user turn; the assistant role is called "model"
    out = []
    system = ""
    for m in messages:
        if m.role == "system":
            system = m.content + "\n\n"
        elif m.role == "user":
            out.append(f"<start_of_turn>user\n{system}{m.content}"
                       f"<end_of_turn>\n")
            system = ""
        else:
            out.append(f"<start_of_turn>model\n{m.content}"
                       f"<end_of_turn>\n")
    if agp:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def _render_inst(d: dict, messages: list[Message], agp: bool) -> str:
    sys_wrap = d.get("sys_wrap", "merge")
    trailing = " " if d.get("trailing_space") else ""
    out = []
    system, _ = (None, None)
    if sys_wrap == "sys":
        system, messages = _split_system(messages, d.get("default_system"))
    pending_sys = ""
    first = True
    for m in messages:
        if m.role == "system":         # merge style
            pending_sys = m.content + "\n\n"
        elif m.role == "user":
            body = m.content
            if sys_wrap == "sys" and first and system is not None:
                body = f"<<SYS>>\n{system}\n<</SYS>>\n\n{m.content}"
            out.append(f"[INST] {pending_sys}{body} [/INST]{trailing}")
            pending_sys = ""
            first = False
        else:
            out.append(f" {m.content}</s>" if not trailing
                       else f"{m.content}</s>")
    return "".join(out)


def _render_roletag(d: dict, messages: list[Message], agp: bool) -> str:
    end = d["end"]
    out = []
    for m in messages:
        if end == "\n":
            out.append(f"<|{m.role}|>\n{m.content}\n")
        else:
            out.append(f"<|{m.role}|>\n{m.content}{end}")
    if agp:
        out.append("<|assistant|>\n")
    return "".join(out)


def _render_colon(d: dict, messages: list[Message], agp: bool) -> str:
    user, asst, sep = d["user"], d["asst"], d.get("sep", "\n")
    sys_mode = d.get("sys", "label")
    out = []
    system, rest = _split_system(messages, d.get("default_system"))
    if system is not None:
        if sys_mode == "prefix":
            out.append(system + "\n\n")
        elif sys_mode == "rwkv":
            out.append(f"{user}{system}{sep}{asst} OK{sep}")
        else:
            out.append(f"System: {system}\n\n"
                       if d.get("family") != "instruct" else
                       f"System: {system}\n")
    for m in rest:
        if m.role == "user":
            out.append(f"{user}{m.content}{sep}")
        else:
            out.append(f"{asst.rstrip()} {m.content}{sep}")
    if agp:
        out.append(asst)
    return "".join(out)


def _render_instruct(d: dict, messages: list[Message], agp: bool) -> str:
    # the original generic INSTRUCT rendering (pinned by tests)
    out = []
    for m in messages:
        if m.role == "system":
            out.append(f"System: {m.content}\n")
        elif m.role == "user":
            out.append(f"User: {m.content}\n")
        else:
            out.append(f"Assistant: {m.content}\n")
    if agp:
        out.append("Assistant: ")
    return "".join(out)


def _render_alpaca(d: dict, messages: list[Message], agp: bool) -> str:
    out = []
    for m in messages:
        if m.role == "system":
            out.append(m.content + "\n\n")
        elif m.role == "user":
            out.append(f"### Instruction:\n{m.content}\n\n")
        else:
            out.append(f"### Response:\n{m.content}\n\n")
    if agp:
        out.append("### Response:\n")
    return "".join(out)


def _render_hash(d: dict, messages: list[Message], agp: bool) -> str:
    out = []
    system, rest = _split_system(messages, d.get("default_system"))
    if system is not None:
        label = d.get("sys_label", "")
        out.append(f"{label}{system}\n\n")
    for m in rest:
        if m.role == "user":
            out.append(f"{d['user_label']}{m.content}\n\n")
        else:
            out.append(f"{d['resp_label']}{m.content}\n\n")
    if agp:
        out.append(d["resp_label"])
    return "".join(out)


def _render_cohere(d: dict, messages: list[Message], agp: bool) -> str:
    nl = "\n" if d.get("newline") else ""
    role_tok = {"system": "<|SYSTEM_TOKEN|>", "user": "<|USER_TOKEN|>",
                "assistant": "<|CHATBOT_TOKEN|>"}
    out = []
    system, rest = _split_system(messages, d.get("default_system"))
    if system is not None:
        out.append(f"<|START_OF_TURN_TOKEN|><|SYSTEM_TOKEN|>{system}"
                   f"<|END_OF_TURN_TOKEN|>{nl}")
    for m in rest:
        out.append(f"<|START_OF_TURN_TOKEN|>{role_tok[m.role]}{m.content}"
                   f"<|END_OF_TURN_TOKEN|>{nl}")
    if agp:
        out.append("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")
    return "".join(out)


def _render_baichuan(d: dict, messages: list[Message], agp: bool) -> str:
    out = []
    for m in messages:
        if m.role in ("system", "user"):
            out.append(f"<reserved_106>{m.content}<reserved_107>")
        else:
            out.append(m.content)
    return "".join(out)


def _render_chatglm(d: dict, messages: list[Message], agp: bool) -> str:
    out = ["[gMASK]<sop>"]
    for m in messages:
        if m.role == "system":
            out.append(f"<|system|>\n{m.content}")
        elif m.role == "user":
            out.append(f"<|user|>\n{m.content}")
        else:
            out.append(f"<|assistant|>\n{m.content}")
    if agp:
        out.append("<|assistant|>\n")
    return "".join(out)


def _render_granite(d: dict, messages: list[Message], agp: bool) -> str:
    out = []
    system, rest = _split_system(messages, d.get("default_system"))
    if system is not None:
        out.append(f"<|start_of_role|>system<|end_of_role|>{system}\n")
    for m in rest:
        out.append(f"<|start_of_role|>{m.role}<|end_of_role|>{m.content}\n")
    if agp:
        out.append("<|start_of_role|>assistant<|end_of_role|>")
    return "".join(out)


def _render_nemotron(d: dict, messages: list[Message], agp: bool) -> str:
    out = []
    system, rest = _split_system(messages, d.get("default_system"))
    if system is not None:
        out.append(f"<extra_id_0>System\n{system}\n")
    for m in rest:
        role = "User" if m.role == "user" else "Assistant"
        out.append(f"<extra_id_1>{role}\n{m.content}\n")
    if agp:
        out.append("<extra_id_1>Assistant\n")
    return "".join(out)


def _render_exaone(d: dict, messages: list[Message], agp: bool) -> str:
    out = []
    system, rest = _split_system(messages, d.get("default_system"))
    if system is not None:
        out.append(f"[|system|]{system}[|endofturn|]\n")
    for m in rest:
        if m.role == "user":
            out.append(f"[|user|]{m.content}\n[|endofturn|]\n")
        else:
            out.append(f"[|assistant|]{m.content}[|endofturn|]\n")
    if agp:
        out.append("[|assistant|]")
    return "".join(out)


def _render_openchat(d: dict, messages: list[Message], agp: bool) -> str:
    out = []
    system, rest = _split_system(messages, None)
    first_user = True
    for m in rest:
        if m.role == "user":
            sys_part = (f"{system}\n\n" if system and first_user else "")
            out.append(f"GPT4 Correct User: {sys_part}{m.content}"
                       f"<|end_of_turn|>")
            first_user = False
        else:
            out.append(f"GPT4 Correct Assistant: {m.content}"
                       f"<|end_of_turn|>")
    if agp:
        out.append("GPT4 Correct Assistant:")
    return "".join(out)


def _render_starcoder(d: dict, messages: list[Message], agp: bool) -> str:
    out = []
    system, rest = _split_system(messages, None)
    if system is not None:
        out.append(f"# {system}\n")
    out.extend(m.content for m in rest)
    return "".join(out)


def _render_fim(d: dict, messages: list[Message], agp: bool) -> str:
    # prefix = user content; suffix = system slot (reference convention:
    # apply(user_text=prefix, system_prompt=suffix), lib.rs:1542)
    system, rest = _split_system(messages, None)
    prefix = "".join(m.content for m in rest if m.role == "user")
    return f"<fim_prefix>{prefix}<fim_suffix>{system or ''}<fim_middle>"


_FAMILIES = {
    "chatml": _render_chatml,
    "header": _render_header,
    "gemma": _render_gemma,
    "inst": _render_inst,
    "roletag": _render_roletag,
    "colon": _render_colon,
    "alpaca": _render_alpaca,
    "hash": _render_hash,
    "cohere": _render_cohere,
    "baichuan": _render_baichuan,
    "chatglm": _render_chatglm,
    "granite": _render_granite,
    "nemotron": _render_nemotron,
    "exaone": _render_exaone,
    "openchat": _render_openchat,
    "starcoder": _render_starcoder,
    "fim": _render_fim,
}


# --------------------------------------------------------------------------
# Rendering entry points
# --------------------------------------------------------------------------
def render_chat(
    template: TemplateType,
    messages: list[Message],
    add_generation_prompt: bool = True,
) -> str:
    """Multi-turn rendering (lib.rs:1122/2240)."""
    if template == TemplateType.RAW:
        return "\n".join(m.content for m in messages)
    if template == TemplateType.INSTRUCT:
        return _render_instruct({}, messages, add_generation_prompt)
    d = _DEF[template]
    return _FAMILIES[d["family"]](d, messages, add_generation_prompt)


def apply(
    template: TemplateType,
    prompt: str,
    system_prompt: str | None = None,
) -> str:
    """Single-prompt application (lib.rs:1122 ``apply``)."""
    msgs = []
    if system_prompt:
        msgs.append(Message("system", system_prompt))
    msgs.append(Message("user", prompt))
    if template == TemplateType.RAW:
        return prompt if not system_prompt else f"{system_prompt}\n{prompt}"
    return render_chat(template, msgs)


def validate_output(template: TemplateType, text: str) -> list[str]:
    """Post-generation output validation (reference lib.rs:3103): flag
    template-token leakage — control markers that should have been
    consumed as stop sequences appearing in user-visible text."""
    leak_markers = _DEF.get(template, {}).get("leaks", ())
    problems = [f"template marker leaked into output: {m!r}"
                for m in leak_markers if m in text]
    for ch in ("￾", "￿"):
        if ch in text:
            problems.append(f"invalid unicode {ch!r} in output")
    return problems


def spec_for(template: TemplateType) -> TemplateSpec:
    return SPECS[template]


from .jinja import (ChatTemplateError, render_chat_embedded,  # noqa: E402
                    render_jinja)

__all__ = [
    "TemplateType",
    "Message",
    "TemplateSpec",
    "detect",
    "render_chat",
    "apply",
    "spec_for",
    "render_jinja",
    "render_chat_embedded",
    "ChatTemplateError",
]
