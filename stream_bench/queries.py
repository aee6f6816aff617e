"""Synthetic query text: 10 domains x 3 complexity classes.

Copied from benchmarks/queries.py (the JAX-era benchmark folder), so
that the yardstick lives with this benchmark; the traffic generator
(traffic.py) draws prompt text from it. Pure Python: imports only
``random``."""
from __future__ import annotations

import random

DOMAINS = {
    "hpc": ["MPI collectives", "SLURM job arrays", "GPU memory hierarchies",
            "parallel file systems", "InfiniBand networking"],
    "math": ["eigenvalue decompositions", "measure theory", "group homomorphisms",
             "partial differential equations", "convex duality"],
    "stats_ml": ["gradient descent", "variational inference", "random forests",
                 "attention mechanisms", "cross-validation"],
    "phys_chem": ["entropy", "molecular orbitals", "quantum tunnelling",
                  "reaction kinetics", "phase transitions"],
    "engineering": ["beam deflection", "control loops", "signal filtering",
                    "finite element methods", "thermal management"],
    "life_sci": ["CRISPR editing", "protein folding", "neural signalling",
                 "immune responses", "gene expression"],
    "cs_software": ["hash tables", "race conditions", "garbage collection",
                    "database indexing", "compiler optimization"],
    "philosophy": ["utilitarianism", "epistemic justification", "free will",
                   "the trolley problem", "moral realism"],
    "social_sci": ["survey sampling bias", "supply and demand", "social capital",
                   "voting systems", "urbanization"],
    "history": ["the printing press", "the silk road", "the industrial revolution",
                "ancient trade routes", "the space race"],
}

LOW_TEMPLATES = [
    "What is {topic}?",
    "Define {topic} in one sentence.",
    "Who first described {topic}?",
    "When was {topic} introduced?",
    "List three examples of {topic}.",
    "What is the capital concept behind {topic}?",
    "How many components does {topic} have?",
]

MEDIUM_TEMPLATES = [
    "Explain how {topic} relates to {topic2} and compare their trade-offs.",
    "Compare and contrast {topic} with {topic2}, then summarize when to use each.",
    "Walk me through how {topic} works and why it matters for {topic2}.",
    "Explain the main failure modes of {topic} and how practitioners mitigate them.",
    "Analyze the relationship between {topic} and {topic2} with concrete examples.",
    "Describe how to combine {topic} and {topic2} in a real project, step by step.",
]

HIGH_TEMPLATES = [
    "Prove, from first principles, the convergence properties underlying {topic}, "
    "and critique the standard assumptions in depth.",
    "Design a novel research methodology combining {topic} and {topic2}; derive its "
    "theoretical limits and propose an evaluation protocol for an open problem.",
    "Derive the governing equations of {topic} step by step, analyze the edge cases "
    "where they break down, and propose a publishable extension to the frontier.",
    "Critically evaluate the state-of-the-art research on {topic}, identify an open "
    "problem, and sketch a novel proof strategy with detailed error analysis.",
    "Given conflicting expert judgments about {topic}, construct a novel reasoning "
    "path that reconciles them, prove its consistency, and analyze its trade-offs "
    "against {topic2} in depth.",
]


# Confusables: queries whose surface features mislead (the realistic
# hard cases — a verbose trivial question, a terse expert one, ...).
CONFUSABLE = [
    (0, "I was wondering, in the broadest possible terms and with every relevant "
        "caveat you can think of, and apologies for the long preamble, what is "
        "{topic}, exactly, at the end of the day?"),
    (0, "Quick one: {topic} — what is it? Also, what is {topic2}? And how many "
        "kinds are there? Just definitions please, nothing deep."),
    (1, "Compare {topic} and {topic2} — no novel research needed, just the "
        "standard trade-offs practitioners already prove out in production."),
    (1, "How does {topic} work?"),
    (2, "Prove {topic} converges."),
    (2, "Is there a novel reconciliation of {topic} and {topic2}? Sketch one."),
]


def generate(n_per_class: int = 400, seed: int = 0, split: str = "test",
             confusable_frac: float = 0.2):
    """Returns (texts, labels) — labels: 0=LOW, 1=MEDIUM, 2=HIGH.

    Template-level holdout: the train split and test split draw from
    DISJOINT template halves, so a classifier cannot memorize surface
    templates; ``confusable_frac`` of each class comes from the shared
    hard pool where surface features mislead."""
    rng = random.Random(seed)
    domains = list(DOMAINS)
    half = 0 if split == "train" else 1

    def pick(templates):
        n = len(templates)
        pool = templates[: n // 2] if half == 0 else templates[n // 2:]
        return rng.choice(pool)

    texts, labels = [], []
    for cls, templates in ((0, LOW_TEMPLATES), (1, MEDIUM_TEMPLATES),
                           (2, HIGH_TEMPLATES)):
        n_conf = int(n_per_class * confusable_frac)
        hard = [t for c, t in CONFUSABLE if c == cls]
        for i in range(n_per_class):
            dom = domains[i % len(domains)]
            topics = DOMAINS[dom]
            t = rng.choice(hard) if i < n_conf else pick(templates)
            q = t.format(topic=rng.choice(topics), topic2=rng.choice(topics))
            texts.append(q)
            labels.append(cls)
    order = list(range(len(texts)))
    rng.shuffle(order)
    return [texts[i] for i in order], [labels[i] for i in order]
