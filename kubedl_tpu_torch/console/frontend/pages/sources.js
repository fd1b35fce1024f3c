// Data-source and code-source config pages (reference pages/DataConfig +
// GitConfig/CodeConfig): CRUD over the ConfigMap-backed stores.
import { api, esc, route, t } from "../app.js";

function sourceTable(kindLabel, fields, rows) {
  return `
    <table><thead><tr>
      ${fields.map(f => `<th>${esc(f.label)}</th>`).join("")}
      <th></th></tr></thead><tbody>
      ${Object.values(rows).map(r => `<tr>
        ${fields.map(f =>
          `<td class="${f.muted ? "muted" : ""}">${esc(r[f.key])}</td>`)
          .join("")}
        <td class="actions">
          <button class="ghost" data-edit="${esc(r.name)}">
            ${esc(t("sources.edit"))}</button>
          <button class="danger" data-del="${esc(r.name)}">
            ${esc(t("jobs.delete"))}</button></td>
      </tr>`).join("")}
    </tbody></table>
    ${Object.keys(rows).length ? "" :
      `<p class="muted">no ${kindLabel} yet</p>`}`;
}

function sourceForm(fields, values = {}) {
  return `
    <div class="form-grid">
      ${fields.map(f => `
        <label>${esc(f.label)}</label>
        <input data-field="${f.key}" value="${esc(values[f.key] || "")}"
               ${values.name && f.key === "name" ? "readonly" : ""}
               placeholder="${esc(f.placeholder || "")}">`).join("")}
    </div>
    <div class="row">
      <button class="primary" id="s-save">${esc(t("sources.save"))}</button>
      <button id="s-cancel">cancel</button>
      <span id="s-msg" class="error"></span>
    </div>`;
}

async function viewSources(app, { title, base, fields }) {
  const rows = await api(base);
  app.innerHTML = `
    <div class="panel">
      <div class="row"><h2 style="margin:0">${esc(title)}</h2>
        <span style="flex:1"></span>
        <button class="primary" id="s-add">${esc(t("sources.add"))}</button>
      </div>
      <div id="s-list">${sourceTable(title, fields, rows)}</div>
      <div id="s-form" hidden></div>
    </div>`;
  const formDiv = app.querySelector("#s-form");
  const listDiv = app.querySelector("#s-list");

  const openForm = (values = {}) => {
    formDiv.hidden = false;
    listDiv.hidden = true;
    formDiv.innerHTML = sourceForm(fields, values);
    formDiv.querySelector("#s-cancel").onclick = () => route();
    formDiv.querySelector("#s-save").onclick = async () => {
      const body = {};
      formDiv.querySelectorAll("[data-field]").forEach(inp => {
        body[inp.dataset.field] = inp.value;
      });
      try {
        await api(base, { method: values.name ? "PUT" : "POST",
                          body: JSON.stringify(body) });
        route();
      } catch (e) {
        formDiv.querySelector("#s-msg").textContent = e.message;
      }
    };
  };

  app.querySelector("#s-add").onclick = () => openForm();
  app.querySelectorAll("[data-edit]").forEach(btn => btn.onclick = () =>
    openForm(rows[btn.dataset.edit] || { name: btn.dataset.edit }));
  app.querySelectorAll("[data-del]").forEach(btn => btn.onclick = async () => {
    await api(`${base}/${encodeURIComponent(btn.dataset.del)}`,
              { method: "DELETE" });
    route();
  });
}

export async function viewDataSources(app) {
  await viewSources(app, {
    title: t("sources.data"), base: "/datasource",
    fields: [
      { key: "name", label: "Name", placeholder: "imagenet" },
      { key: "type", label: "Type", placeholder: "pvc" },
      { key: "pvc_name", label: "PVC", placeholder: "imagenet-pvc" },
      { key: "local_path", label: "Mount path", placeholder: "/data",
        muted: true },
      { key: "description", label: "Description", muted: true },
    ],
  });
}

export async function viewCodeSources(app) {
  await viewSources(app, {
    title: t("sources.code"), base: "/codesource",
    fields: [
      { key: "name", label: "Name", placeholder: "trainer-repo" },
      { key: "type", label: "Type", placeholder: "git" },
      { key: "code_path", label: "Repo URL",
        placeholder: "https://github.com/org/repo.git" },
      { key: "default_branch", label: "Branch", placeholder: "main",
        muted: true },
      { key: "local_path", label: "Clone path",
        placeholder: "/workspace/code", muted: true },
    ],
  });
}
